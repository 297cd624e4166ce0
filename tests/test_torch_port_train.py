"""The port's training slice against the JAX package, on the CPU.

64² crops, 3 classes (icospheres and a box, the box symmetric), batch 2,
2 GRU iterations, full width, JAX init with seeded noise bridged into the
port. JAX renders with the Pallas tile rasterizer in interpret mode, the
port with its plain tile pass.

- ``scflow_loss`` (train mode) on the same rendered inputs: loss terms,
  the updated BN running statistics and the gradient of every parameter.
- ``make_train_step`` twice and ``make_multi_cycle_train_step`` once: the
  parameters after them, against ``make_train_step`` /
  ``make_multi_cycle_train_step`` of the JAX package with its optax chain.
- ``synthetic_batch``: its structure.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from port_common import IMAGE, NUM_CLASS, jax_refiner_variables

ITERS = 2
RADIUS = 20.0
SYMMETRIC = (1,)
NUM_POINTS = 64


@pytest.fixture(scope="module")
def jax_side():
    from scflow_tpu.data import synthetic_batch
    from scflow_tpu.rendering import Renderer, make_test_meshes
    from scflow_tpu.training import LossConfig, OptimConfig, build_points_bank

    model, cfg, variables = jax_refiner_variables(iters=ITERS)
    cfg = dataclasses.replace(cfg, loss=LossConfig(num_loss_points=NUM_POINTS),
                              optim=OptimConfig(total_steps=100))
    bank = make_test_meshes(num_classes=NUM_CLASS, subdivisions=2,
                            radius=RADIUS)
    renderer = Renderer(bank, image_size=IMAGE, rasterizer="pallas")
    points = build_points_bank(bank, symmetric_classes=SYMMETRIC,
                               num_points=NUM_POINTS)
    batch = jax.tree.map(np.asarray, synthetic_batch(
        jax.random.PRNGKey(3), renderer, 2))
    batch["real_images"] = np.round(batch["real_images"] * 255).astype(np.uint8)
    batch["gt_masks"] = batch["gt_masks"].astype(np.uint8)
    # every case carries sample_valid, so one JAX gradient program serves all
    batch["sample_valid"] = np.ones(2, np.float32)
    return model, cfg, variables, renderer, points, batch


def port_side(variables):
    """(model with the bridged weights, config, renderer, points bank) on
    the CPU."""
    from scflow_torch.rendering import Renderer, make_test_meshes
    from scflow_torch.training import (Config, LossConfig, ModelConfig,
                                       OptimConfig, RenderConfig,
                                       build_model, build_points_bank)
    from scflow_torch.weights import load_jax_variables

    cfg = Config(model=ModelConfig(num_class=NUM_CLASS, iters=ITERS,
                                   test_iters=ITERS),
                 loss=LossConfig(num_loss_points=NUM_POINTS),
                 optim=OptimConfig(total_steps=100),
                 render=RenderConfig(image_size=IMAGE))
    model = build_model(cfg, device="cpu")
    load_jax_variables(model, variables)
    bank = make_test_meshes(NUM_CLASS, subdivisions=2, radius=RADIUS,
                            device="cpu")
    return (model, cfg, Renderer(bank, image_size=IMAGE),
            build_points_bank(bank, symmetric_classes=SYMMETRIC,
                              num_points=NUM_POINTS))


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def rendered(jax_side):
    """The batch with JAX's render at the reference pose, as numpy."""
    from scflow_tpu.training import render_at_pose

    _, cfg, _, renderer, _, batch = jax_side
    images, depth, mask = jax.jit(lambda b: render_at_pose(
        renderer, b["ref_rotations"], b["ref_translations"], b["k"],
        b["labels"], cfg.data.normalize_mean, cfg.data.normalize_std))(batch)
    return dict(batch, rendered_images=np.asarray(images),
                rendered_depths=np.asarray(depth),
                rendered_masks=np.asarray(mask))


@pytest.fixture(scope="module")
def grad_fn(jax_side):
    """JAX's jitted ``value_and_grad`` of ``scflow_loss`` in train mode."""
    from scflow_tpu.training import scflow_loss

    model, cfg, _, _, points, _ = jax_side
    return jax.jit(jax.value_and_grad(
        lambda p, s, b: scflow_loss(p, s, b, model=model, points_bank=points,
                                    cfg=cfg, train=True), has_aux=True))


def port_gradients(variables, batch):
    """(loss, metrics, the port model after ``scflow_loss`` + backward)."""
    from scflow_torch.training import scflow_loss

    pmodel, pcfg, _, ppoints = port_side(variables)
    loss, metrics, _ = scflow_loss(
        pmodel, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
        ppoints, pcfg, train=True)
    loss.backward()
    return loss, metrics, pmodel


SAMPLE_VALID = {"all": np.array([1.0, 1.0], np.float32),
                "padded": np.array([1.0, 0.0], np.float32)}


@pytest.mark.parametrize("valid", list(SAMPLE_VALID))
def test_scflow_loss_and_gradients(jax_side, rendered, grad_fn, valid):
    """Loss terms within rtol 1e-4. BN running statistics: statistics of
    activations after up to 15 f32 convolutions summed in another order
    than XLA's, so the encoder oracle bound of test_torch_port_model.py
    (rtol 1e-4, atol 2e-4).

    Gradients: this f32 gradient is ill-conditioned. Train-mode BN at batch
    2 subtracts the gradient's mean and x̂ components, and JAX's own
    gradient moves by ~2e-3 of its norm (a context-encoder leaf by ~3e-2)
    when the rendered images change by one part in 1e6. The test measures
    that spread and holds the port's whole gradient within
    max(1e-3, 5 × spread) of JAX's (measured: 4.9e-3 and 2.5e-3 against
    spreads of 2.1e-3 and 2.2e-3), and every leaf within 0.2 of its norm
    (measured at most 8.9e-2, a context-encoder norm scale). Leaves whose
    gradient is below 1e-4 of the whole norm (the biases of convolutions
    followed by IN or train-mode BN have an exact gradient of 0: both
    sides give rounding noise) are held to 1e-4 of the whole norm.
    """
    from scflow_torch.weights import to_jax_variables

    variables = jax_side[2]
    batch = dict(rendered, sample_valid=SAMPLE_VALID[valid])
    (_, (want_stats, want_metrics, _)), want_grads = grad_fn(
        variables["params"], variables["batch_stats"], batch)
    nudged = dict(batch, rendered_images=batch["rendered_images"]
                  * np.float32(1 + 1e-6))
    _, nudged_grads = grad_fn(variables["params"], variables["batch_stats"],
                              nudged)

    _, metrics, pmodel = port_gradients(variables, batch)
    for key in ("loss", "loss_pose", "loss_flow", "loss_mask",
                "seq_pose_loss", "seq_flow_loss", "seq_mask_loss"):
        np.testing.assert_allclose(metrics[key].detach().numpy(),
                                   np.asarray(want_metrics[key]), rtol=1e-4,
                                   err_msg=key)
    got = to_jax_variables(pmodel)
    for k, v in flatten_dict(jax.tree.map(np.asarray, want_stats),
                             sep="/").items():
        np.testing.assert_allclose(
            flatten_dict(got["batch_stats"], sep="/")[k], v, rtol=1e-4,
            atol=2e-4, err_msg=k)
    want = flatten_dict(jax.tree.map(np.asarray, want_grads), sep="/")
    got = flatten_dict(to_jax_variables(pmodel, grad=True)["params"], sep="/")
    assert set(got) == set(want)
    nudged = flatten_dict(jax.tree.map(np.asarray, nudged_grads), sep="/")
    keys = sorted(want)

    def flat(tree):
        return np.concatenate([tree[k].ravel() for k in keys])

    spread = rel_err(flat(nudged), flat(want))
    whole = rel_err(flat(got), flat(want))
    norm = np.linalg.norm(flat(want))
    small = {k for k in keys if np.linalg.norm(want[k]) < 1e-4 * norm}
    per_leaf = {k: rel_err(got[k], want[k]) for k in keys if k not in small}
    worst = max(per_leaf, key=per_leaf.get)
    print(f"scflow_loss gradients ({valid}): JAX's spread {spread:.2e}, port "
          f"{whole:.2e}, worst leaf {worst} {per_leaf[worst]:.2e}, "
          f"{len(small)} small leaves")
    assert whole <= max(1e-3, 5 * spread)
    assert per_leaf[worst] <= 0.2, worst
    for k in small:
        assert np.linalg.norm(got[k] - want[k]) <= 1e-4 * norm, k


def _flat(tree) -> dict:
    return flatten_dict(jax.tree.map(np.asarray, tree), sep="/")


def _port_step_grads(pmodel, metrics) -> dict:
    """The port's gradient of the update just taken: ``.grad`` after the
    clip, scaled back by the clip factor."""
    from scflow_torch.weights import to_jax_variables

    factor = max(metrics["grad_norm"].item() / 10.0, 1.0)
    return {k: v * factor for k, v in _flat(
        to_jax_variables(pmodel, grad=True)["params"]).items()}


@pytest.fixture(scope="module")
def jax_first_step(jax_side):
    """(optax chain, initial TrainState, JAX train step, state after one
    update)."""
    from scflow_tpu.training import make_optimizer, make_train_step
    from scflow_tpu.training.steps import TrainState

    model, cfg, variables, renderer, points, batch = jax_side
    tx, _ = make_optimizer(cfg)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    step = make_train_step(model, renderer, points, cfg, tx)
    return tx, state, step, step(state, batch)[0]


@pytest.mark.parametrize("cycles", [1, 2], ids=["two_steps", "two_cycles"])
def test_train_steps_match_jax(jax_side, rendered, grad_fn, jax_first_step,
                               cycles):
    """Parameters after two updates: two ``make_train_step`` calls, or one
    2-cycle ``make_multi_cycle_train_step`` call, against the JAX steps.

    Adam's update is about ±lr wherever |g| ≫ eps, so an element whose
    gradient lies within the two sides' gradient difference of 0 can change
    sign and move by 2·lr; where the two updates' gradients have opposite
    signs, Adam's second step divides a nearly cancelled mean by the RMS
    and amplifies any gradient difference. So updates are compared where
    each update's JAX gradient is at least 5× the RMS of that update's
    port−JAX gradient difference over its leaf, and the two gradients
    share their sign on both sides (at least 10% of the elements; 21–31%
    measured, and the excluded count is printed). There, in units of the two learning rates'
    sum, the update error's median is at most 0.01, its 99th percentile at
    most 0.1 and its worst at most 0.5 (measured: 0.003, 0.036, 0.28);
    everywhere it is at most 2.5 (Adam's steps are bounded).
    """
    from scflow_torch.training import (make_multi_cycle_train_step,
                                       make_optimizer, make_train_step,
                                       onecycle_lr)
    from scflow_torch.weights import to_jax_variables
    from scflow_tpu.training import render_at_pose
    from scflow_tpu.training.steps import \
        make_multi_cycle_train_step as jax_multi_cycle

    model, cfg, variables, renderer, points, batch = jax_side
    tx, state, step, mid = jax_first_step
    (_, (_, _, out)), g1 = grad_fn(variables["params"],
                                   variables["batch_stats"], rendered)
    second = rendered
    if cycles == 1:
        end, jmetrics = step(mid, batch)
    else:
        end, jmetrics = jax_multi_cycle(model, renderer, points, cfg, tx,
                                        cycles=2)(state, batch)
        # the second cycle renders at the first cycle's last pose
        second = dict(batch, ref_rotations=np.asarray(out.rotations[-1]),
                      ref_translations=np.asarray(out.translations[-1]))
        images, depth, mask = jax.jit(lambda b: render_at_pose(
            renderer, b["ref_rotations"], b["ref_translations"], b["k"],
            b["labels"], cfg.data.normalize_mean,
            cfg.data.normalize_std))(second)
        second = dict(second, rendered_images=np.asarray(images),
                      rendered_depths=np.asarray(depth),
                      rendered_masks=np.asarray(mask))
    _, g2 = grad_fn(mid.params, mid.batch_stats, second)
    jax_grads = [_flat(g1), _flat(g2)]

    pmodel, pcfg, prenderer, ppoints = port_side(variables)
    opt = make_optimizer(pcfg, pmodel.parameters())
    if cycles == 1:
        pstep = make_train_step(pmodel, prenderer, ppoints, pcfg, opt,
                                device="cpu")
        port_grads = [_port_step_grads(pmodel, pstep(batch))]
        metrics = pstep(batch)
    else:
        # the first cycle is the first step: its gradient from a port twin
        twin, _, trenderer, tpoints = port_side(variables)
        tstep = make_train_step(twin, trenderer, tpoints, pcfg,
                                make_optimizer(pcfg, twin.parameters()),
                                device="cpu")
        port_grads = [_port_step_grads(twin, tstep(batch))]
        metrics = make_multi_cycle_train_step(
            pmodel, prenderer, ppoints, pcfg, opt, cycles=2,
            device="cpu")(batch)
        np.testing.assert_allclose(metrics["cycle0_loss"].item(),
                                   float(jmetrics["cycle0_loss"]), rtol=1e-3)
    port_grads.append(_port_step_grads(pmodel, metrics))
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]),
                               rtol=1e-3)
    lr_sum = onecycle_lr(0, pcfg.optim) + onecycle_lr(1, pcfg.optim)
    p0 = flatten_dict(variables["params"], sep="/")
    want = _flat(end.params)
    got = _flat(to_jax_variables(pmodel)["params"])
    kept_du = []
    total = 0
    worst_all = 0.0
    for k in sorted(p0):
        du = np.abs((got[k] - p0[k]) - (want[k] - p0[k])) / lr_sum
        ok = np.ones(du.shape, bool)
        for gj, gp in zip(jax_grads, port_grads):
            ok &= np.abs(gj[k]) >= 5 * np.sqrt(np.mean((gp[k] - gj[k]) ** 2))
        for grads in (jax_grads, port_grads):
            ok &= grads[0][k] * grads[1][k] > 0
        kept_du.append(du[ok])
        total += du.size
        worst_all = max(worst_all, float(du.max()))
    kept_du = np.concatenate(kept_du)
    median, q99 = np.quantile(kept_du, [0.5, 0.99])
    print(f"train steps ({cycles} cycle(s)): {total - kept_du.size} of "
          f"{total} elements under the floor; above it the update error's "
          f"median {median:.4f}, 99th percentile {q99:.4f}, worst "
          f"{kept_du.max():.3f} (·lr); {worst_all:.3f}·lr overall")
    assert kept_du.size >= 0.1 * total
    assert median <= 0.01 and q99 <= 0.1 and kept_du.max() <= 0.5
    assert worst_all <= 2.5
    # the BN running statistics moved as JAX's did; the second update's are
    # of activations at parameters that differ where Adam's sign flipped, so
    # atol 1e-3 (measured 3.3e-4), 5× the single update's bound
    got_stats = _flat(to_jax_variables(pmodel)["batch_stats"])
    for k, v in _flat(end.batch_stats).items():
        np.testing.assert_allclose(got_stats[k], v, rtol=1e-4, atol=1e-3,
                                   err_msg=k)


def test_synthetic_batch_structure():
    """Shapes, a visible object in every sample, a jittered pose, and one
    seed giving one batch (its draws come from a CPU generator; the card
    test of the same seed on both devices is in test_torch_port_kernels.py)."""
    from scflow_torch.data import synthetic_batch
    from scflow_torch.rendering import Renderer, make_test_meshes

    renderer = Renderer(make_test_meshes(NUM_CLASS, subdivisions=2,
                                         radius=RADIUS, device="cpu"),
                        image_size=IMAGE)
    batch = synthetic_batch(torch.Generator().manual_seed(0), renderer, 3)
    n, (h, w) = 3, IMAGE
    shapes = {"real_images": (n, h, w, 3), "gt_masks": (n, h, w),
              "gt_rotations": (n, 3, 3), "gt_translations": (n, 3),
              "ref_rotations": (n, 3, 3), "ref_translations": (n, 3),
              "k": (n, 3, 3), "labels": (n,)}
    assert {k: tuple(v.shape) for k, v in batch.items()} == shapes
    assert batch["real_images"].min() >= 0 and batch["real_images"].max() <= 1
    assert (batch["gt_masks"].sum((1, 2)) > 50).all()          # visible
    assert (batch["labels"] >= 0).all() and (batch["labels"] < NUM_CLASS).all()
    r = batch["gt_rotations"]
    torch.testing.assert_close(r @ r.transpose(1, 2),
                               torch.eye(3).expand(n, 3, 3), atol=1e-5,
                               rtol=0)
    assert not torch.allclose(batch["ref_rotations"], batch["gt_rotations"])
    assert not torch.allclose(batch["ref_translations"],
                              batch["gt_translations"])
    again = synthetic_batch(torch.Generator().manual_seed(0), renderer, 3)
    for k, v in batch.items():
        assert torch.equal(v, again[k]), k
