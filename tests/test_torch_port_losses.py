"""Training losses, the points bank and the optimizer of the PyTorch port
against the JAX package, on seeded numpy inputs.

Losses: values and their gradients for the predicted poses/flows, both
sides in f32 with sums in different orders, rtol 1e-5 (atol 1e-6 for
values near zero); gradients are sums of many such terms that cancel, so
they get rtol 1e-5 plus 1e-5 of the largest gradient element. The
symmetric matching is an argmin over the same f32 distances: the matched
indices must agree exactly. Points bank: bit for bit. Schedule: value by
value, rtol 1e-6 plus two f32 steps of the peak lr (JAX interpolates in
f32, the port in float64). AdamW after the clip:
rtol 1e-6, atol 1e-9 (the two frameworks round Adam's update differently
by an ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_common import random_rotations
from scflow_torch import losses as tl
from scflow_tpu import losses as jl

VAL_TOL = dict(rtol=1e-5, atol=1e-6)


def assert_grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


N, P, T = 4, 48, 3


def pose_inputs(seed=0):
    """GT poses, T noisy predictions of them, points with padding, a
    symmetric/asymmetric mix and diameters."""
    rng = np.random.default_rng(seed)
    gt_r = random_rotations(rng, N)
    gt_t = np.concatenate([rng.uniform(-30, 30, (N, 2)),
                           rng.uniform(500, 900, (N, 1))], -1).astype(np.float32)
    seq_r = np.stack([random_rotations(rng, N) * 0.02 + gt_r
                      for _ in range(T)]).astype(np.float32)
    seq_t = (gt_t + rng.normal(size=(T, N, 3)) * 5.0).astype(np.float32)
    points = rng.uniform(-60, 60, (N, P, 3)).astype(np.float32)
    valid = rng.uniform(size=(N, P)) > 0.2
    symmetric = np.array([True, False, True, False])
    diameters = rng.uniform(100, 250, N).astype(np.float32)
    return gt_r, gt_t, seq_r, seq_t, points, valid, symmetric, diameters


SAMPLE_WEIGHTS = {"none": None, "zeros": np.array([1, 0, 1, 0], np.float32)}


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_nearest_match_indices_agree():
    gt_r, gt_t, seq_r, seq_t, points, valid, *_ = pose_inputs(1)
    target = np.einsum("nij,npj->npi", gt_r, points) + gt_t[:, None]
    pred = np.einsum("nij,npj->npi", seq_r[0], points) + seq_t[0][:, None]
    want = jax.vmap(jl._nearest_match)(_j(target), _j(pred), _j(valid))
    got = tl._nearest_match(_t(target), _t(pred), _t(valid))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sw", list(SAMPLE_WEIGHTS))
@pytest.mark.parametrize("disentangled,disentangle_z",
                         [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_sequence_pose_loss(loss_type, disentangled, disentangle_z, sw):
    gt_r, gt_t, seq_r, seq_t, points, valid, sym, diam = pose_inputs()
    kw = dict(gamma=0.8, loss_weight=10.0, loss_type=loss_type,
              disentangled=disentangled, disentangle_z=disentangle_z)
    weight = SAMPLE_WEIGHTS[sw]

    def jloss(r, t):
        return jl.sequence_pose_loss(r, t, *map(_j, (gt_r, gt_t, points, valid,
                                                     sym, diam)), **kw,
                                     sample_weight=_j(weight))

    (want, want_per), vjp = jax.vjp(jloss, _j(seq_r), _j(seq_t))
    want_grads = vjp((jnp.ones(()), jnp.zeros((T,))))
    r, t = _t(seq_r).requires_grad_(), _t(seq_t).requires_grad_()
    got, got_per = tl.sequence_pose_loss(
        r, t, *map(_t, (gt_r, gt_t, points, valid, sym, diam)), **kw,
        sample_weight=_t(weight))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **VAL_TOL)
    np.testing.assert_allclose(got_per.detach().numpy(), np.asarray(want_per),
                               **VAL_TOL)
    for g, w in zip((r.grad, t.grad), want_grads):
        assert_grad_close(g.numpy(), w)


@pytest.mark.parametrize("fn", ["point_matching_loss",
                                "disentangled_point_matching_loss"])
def test_point_matching_per_sample(fn):
    gt_r, gt_t, seq_r, seq_t, points, valid, sym, diam = pose_inputs(2)
    args = (seq_r[-1], seq_t[-1], gt_r, gt_t, points, valid, sym, diam)
    want = getattr(jl, fn)(*map(_j, args))
    got = getattr(tl, fn)(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL_TOL)


def flow_inputs(seed=3, h=12, w=16):
    rng = np.random.default_rng(seed)
    gt = (rng.normal(size=(N, h, w, 2)) * 30).astype(np.float32)
    gt[rng.uniform(size=(N, h, w)) < 0.2] = 400.0           # invalid pixels
    gt[0, 0, 0] = (350.0, 0.0)                              # long but valid
    seq = (gt[None] + rng.normal(size=(T, N, h, w, 2))).astype(np.float32)
    valid = (rng.uniform(size=(N, h, w)) > 0.3).astype(np.float32)
    masks = rng.uniform(size=(T, N, h, w)).astype(np.float32)
    gt_mask = (rng.uniform(size=(N, h, w)) > 0.5).astype(np.float32)
    return seq, gt, valid, masks, gt_mask


@pytest.mark.parametrize("sw", list(SAMPLE_WEIGHTS))
def test_sequence_flow_and_mask_losses(sw):
    seq, gt, valid, masks, gt_mask = flow_inputs()
    weight = SAMPLE_WEIGHTS[sw]
    (want_f, want_fp), vjp_f = jax.vjp(
        lambda s: jl.sequence_flow_loss(s, _j(gt), _j(valid), 0.8, 0.1, 400.0,
                                        _j(weight)), _j(seq))
    (want_m, want_mp), vjp_m = jax.vjp(
        lambda m: jl.sequence_mask_loss(m, _j(gt_mask), 0.8, 10.0, _j(weight)),
        _j(masks))
    s, m = _t(seq).requires_grad_(), _t(masks).requires_grad_()
    got_f, got_fp = tl.sequence_flow_loss(s, _t(gt), _t(valid), 0.8, 0.1,
                                          400.0, _t(weight))
    got_m, got_mp = tl.sequence_mask_loss(m, _t(gt_mask), 0.8, 10.0,
                                          _t(weight))
    (got_f + got_m).backward()
    for got, want in ((got_f, want_f), (got_fp, want_fp), (got_m, want_m),
                      (got_mp, want_mp)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **VAL_TOL)
    assert_grad_close(s.grad.numpy(), vjp_f((jnp.ones(()), jnp.zeros(T)))[0])
    assert_grad_close(m.grad.numpy(), vjp_m((jnp.ones(()), jnp.zeros(T)))[0])


@pytest.mark.parametrize("with_valid", [False, True])
def test_raft_flow_and_mask_l1(with_valid):
    seq, gt, valid, masks, gt_mask = flow_inputs(4)
    v = valid if with_valid else None
    np.testing.assert_allclose(
        tl.raft_flow_loss(_t(seq[0]), _t(gt), _t(v)).item(),
        float(jl.raft_flow_loss(_j(seq[0]), _j(gt), _j(v))), **VAL_TOL)
    np.testing.assert_allclose(
        tl.mask_l1_loss(_t(masks[0]), _t(gt_mask)).item(),
        float(jl.mask_l1_loss(_j(masks[0]), _j(gt_mask))), **VAL_TOL)


def test_sequence_loss_weights():
    per = np.array([3.0, 2.0, 1.5, 0.25], np.float32)
    want = jl.sequence_loss(jnp.asarray(per), 0.8)
    got = tl.sequence_loss(torch.from_numpy(per), 0.8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("symmetric", [(), (1,)])
def test_points_bank_bit_for_bit(symmetric):
    from scflow_torch.rendering import make_test_meshes
    from scflow_torch.training import build_points_bank
    from scflow_tpu.rendering import make_test_meshes as jax_meshes
    from scflow_tpu.training import build_points_bank as jax_bank

    # 3 classes of subdivision-2 spheres (162 vertices) and boxes (8):
    # 64 points draw without replacement, 300 with
    for num_points in (64, 300):
        want = jax_bank(jax_meshes(3, subdivisions=2, radius=20.0),
                        symmetric_classes=symmetric, num_points=num_points)
        got = build_points_bank(make_test_meshes(3, subdivisions=2, radius=20.0,
                                                 device="cpu"),
                                symmetric_classes=symmetric,
                                num_points=num_points)
        for name in ("points", "valid", "diameters", "symmetric"):
            g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert g.dtype == w.dtype and np.array_equal(g, w), name
        labels = np.array([2, 0, 1, 2])
        for g, w in zip(got.gather(torch.from_numpy(labels)),
                        want.gather(jnp.asarray(labels))):
            assert np.array_equal(g.numpy(), np.asarray(w))


def _configs(total_steps):
    from scflow_torch.training import Config, OptimConfig
    from scflow_tpu.training import Config as JConfig
    from scflow_tpu.training import OptimConfig as JOptimConfig

    return (Config(optim=OptimConfig(total_steps=total_steps)),
            JConfig(optim=JOptimConfig(total_steps=total_steps)))


@pytest.mark.parametrize("total_steps", [100, 1000])
def test_onecycle_schedule_matches_optax(total_steps):
    from scflow_torch.training import onecycle_lr
    from scflow_tpu.training import make_optimizer

    cfg, jcfg = _configs(total_steps)
    _, schedule = make_optimizer(jcfg)
    for step in range(121):
        want = float(schedule(jnp.int32(step)))
        np.testing.assert_allclose(onecycle_lr(step, cfg.optim), want,
                                   rtol=1e-6, atol=2 ** -22 * cfg.optim.lr,
                                   err_msg=f"step {step}")


def test_clipped_adamw_matches_optax():
    """Two updates on given gradients: the first above the clip norm 10
    (clipped), the second below it."""
    import optax

    from scflow_torch.training import (clip_by_global_norm_, make_optimizer,
                                       onecycle_lr)
    from scflow_tpu.training import make_optimizer as jax_optimizer

    cfg, jcfg = _configs(100)
    rng = np.random.default_rng(7)
    shapes = {"w": (6, 5), "b": (5,), "s": (3, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (8.0, 0.2)]

    tx, _ = jax_optimizer(jcfg)
    jp, state = jax.tree.map(jnp.asarray, params), None
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make_optimizer(cfg, list(tp.values()))
    for step, g in enumerate(grads):
        norm = float(optax.global_norm(g))
        assert (norm > 10.0) == (step == 0)
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        got_norm = clip_by_global_norm_([p.grad for p in tp.values()], 10.0)
        np.testing.assert_allclose(got_norm.item(), norm, rtol=1e-6)
        for group in opt.param_groups:
            group["lr"] = onecycle_lr(step, cfg.optim)
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-9)
