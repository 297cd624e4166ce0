"""The port's RAFT flow(+occlusion) family against the JAX package on the
CPU: convex upsampling, the ``RAFTRefiner`` forward (with and without the
occlusion head, multiview broadcast on either side), ``raft_loss`` and
its gradient, and the eval step with test-time RANSAC-EPnP.

64² crops, 3 classes (icospheres and a box), batch 2, 3 iterations, full
width; the JAX init with seeded noise bridged into the port. JAX renders
with the Pallas tile rasterizer in interpret mode, the port with its plain
tile pass.

The eval step is held in two legs, because with seeded random weights the
flows match no pose and PnP is chaotic (a 1e-6 change of the flow can
flip an inlier or the winning hypothesis):
- the network: flows, occlusions and depth against JAX's;
- PnP: JAX's own flow, occlusion and depth, with the Gumbel draws of JAX's
  ``PRNGKey(0)``, through the port's ``solve_pose_from_flow_core``.
Whole-step poses (the same draws injected) are compared where both sides
fell back (the reference pose, exactly) or the port chose the same
hypothesis on its own network outputs as on JAX's.
"""
import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from port_common import (IMAGE, NUM_CLASS, jax_raft_variables, nchw, nhwc,
                         port_refiner)
from port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_pnp import angle_deg, assert_ransac_like_witness
from scflow_torch.models import decoder as tdecoder
from scflow_torch.models import flow_pose as tflow
from scflow_tpu.models import decoder as jdecoder

ITERS = 3
RADIUS = 20.0
FAMILIES = ("raft_flow_mask", "raft_flow")
# f32 flows after 3 GRU iterations, summed in another order than XLA's
# (measured ≤ 3e-5 px): the SCFlow eval step's flow bound
FLOW_TOL = dict(rtol=2e-3, atol=2e-3)
OCC_TOL = dict(atol=1e-3)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(family, JAX model, its config, variables, bridged port model)."""
    fam = request.param
    jmodel, jcfg, variables = jax_raft_variables(fam, iters=ITERS)
    pmodel, pcfg = port_refiner(variables, iters=ITERS, family=fam)
    return fam, jmodel, jcfg, variables, pmodel, pcfg


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("multiplier", [None, 1.0], ids=["flow", "occlusion"])
def test_convex_upsample(multiplier):
    """×8 convex upsampling of a flow (values × 8) and of an occlusion map
    (multiplier 1) with the same 576-channel weights, f32 1e-5."""
    c = 2 if multiplier is None else 1
    x = rand(2, 8, 6, c, seed=1, scale=3.0)
    w = rand(2, 8, 6, 9 * 64, seed=2, scale=2.0)
    want = jdecoder.convex_upsample(x, w, 8, multiplier)
    got = tdecoder.convex_upsample(nchw(x), nchw(w), 8, multiplier)
    assert got.shape == (2, c, 64, 48)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("view", ["batched", "multiview_real",
                                  "multiview_render"])
def test_raft_refiner_forward(family, view):
    """Per-iteration upsampled flows and occlusions (zeros without the
    occlusion head, as in JAX). Multiview: one unbatched image on one
    side, encoded once and broadcast against the other side's batch."""
    fam, jmodel, _, variables, pmodel, _ = family
    render, real = rand(2, *IMAGE, 3, seed=3), rand(2, *IMAGE, 3, seed=4)
    if view == "multiview_real":
        real = real[0]
    elif view == "multiview_render":
        render = render[0]
    flows, occs = jmodel.apply(variables, render, real)
    with torch.no_grad():
        got_flows, got_occs = pmodel(torch.from_numpy(render),
                                     torch.from_numpy(real))
    assert got_flows.shape == (ITERS, 2, *IMAGE, 2)
    np.testing.assert_allclose(got_flows.numpy(), np.asarray(flows),
                               **FLOW_TOL)
    np.testing.assert_allclose(got_occs.numpy(), np.asarray(occs), **OCC_TOL)
    if fam == "raft_flow":
        assert not got_occs.any()
    print(f"{fam} {view}: flow max err "
          f"{np.abs(got_flows.numpy() - np.asarray(flows)).max():.2e}")


@pytest.fixture(scope="module")
def scene():
    from scflow_tpu.data import synthetic_batch
    from scflow_tpu.rendering import Renderer, make_test_meshes

    renderer = Renderer(make_test_meshes(num_classes=NUM_CLASS,
                                         subdivisions=2, radius=RADIUS),
                        image_size=IMAGE, rasterizer="pallas")
    batch = jax.tree.map(np.asarray, synthetic_batch(
        jax.random.PRNGKey(3), renderer, 2))
    batch["real_images"] = np.round(batch["real_images"] * 255).astype(np.uint8)
    batch["gt_masks"] = batch["gt_masks"].astype(np.uint8)
    return renderer, batch


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_raft_loss_and_gradients(family, scene):
    """``raft_loss`` in train mode on JAX's rendered inputs: the loss terms
    rtol 1e-4; the gradient of every parameter against ``jax.grad``. As
    for ``scflow_loss`` (test_torch_port_train.py), train-mode BN at batch
    2 makes this f32 gradient ill-conditioned, so the whole gradient is
    held within max(1e-3, 5 × JAX's own spread under a 1e-6 relative
    change of the rendered images), every leaf above 1e-4 of the whole
    norm within 0.2 of its norm, the rest within 1e-4 of the whole norm."""
    from scflow_torch.training import raft_loss as port_loss
    from scflow_torch.weights import to_jax_variables
    from scflow_tpu.training import render_at_pose
    from scflow_tpu.training.steps import raft_loss

    fam, jmodel, jcfg, variables, _, _ = family
    renderer, batch = scene
    images, depth, mask = jax.jit(lambda b: render_at_pose(
        renderer, b["ref_rotations"], b["ref_translations"], b["k"],
        b["labels"], jcfg.data.normalize_mean, jcfg.data.normalize_std))(batch)
    full = dict(batch, rendered_images=np.asarray(images),
                rendered_depths=np.asarray(depth),
                rendered_masks=np.asarray(mask))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, s, b: raft_loss(p, s, b, model=jmodel, points_bank=None,
                                  cfg=jcfg, train=True), has_aux=True))
    (_, (_, want_metrics, _)), want_grads = grad_fn(
        variables["params"], variables["batch_stats"], full)
    nudged = dict(full, rendered_images=full["rendered_images"]
                  * np.float32(1 + 1e-6))
    _, nudged_grads = grad_fn(variables["params"], variables["batch_stats"],
                              nudged)

    pmodel, pcfg = port_refiner(variables, iters=ITERS, family=fam)
    loss, metrics, _ = port_loss(
        pmodel, {k: torch.from_numpy(np.array(v)) for k, v in full.items()},
        None, pcfg, train=True)
    loss.backward()
    for key in ("loss", "loss_flow", "loss_mask", "loss_pose",
                "seq_flow_loss", "seq_mask_loss"):
        np.testing.assert_allclose(metrics[key].detach().numpy(),
                                   np.asarray(want_metrics[key]), rtol=1e-4,
                                   atol=1e-7, err_msg=key)
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
    print(f"raft_loss gradients ({fam}): JAX's spread {spread:.2e}, port "
          f"{whole:.2e}, worst leaf {worst} {per_leaf[worst]:.2e}")
    assert whole <= max(1e-3, 5 * spread)
    assert per_leaf[worst] <= 0.2, worst
    for k in small:
        assert np.linalg.norm(got[k] - want[k]) <= 1e-4 * norm, k


def jax_eval_draws(n: int, pixels: int):
    """The Gumbel draws of JAX's eval step (``PRNGKey(0)``, the key
    schedule of ``solve_pose_from_flow``)."""
    key, sub = jax.random.split(jax.random.PRNGKey(0))
    subsample = np.asarray(jax.random.gumbel(sub, (n, pixels)))
    hyp = np.stack([np.asarray(jax.random.gumbel(kk, (64, 1024)))
                    for kk in jax.random.split(key, n)])
    return torch.from_numpy(subsample), torch.from_numpy(hyp)


def pnp_ready(variables: dict) -> dict:
    """The variables with the flow head's output 10× smaller and the
    occlusion head's output bias +2: with the plain seeded init most
    pixels score below the 0.5 visibility threshold and the flows are
    random, so every sample falls back and the PnP leg would only test the
    fallback; here RANSAC finds a pose near the reference."""
    v = jax.tree.map(np.array, variables)
    it = v["params"]["decoder"]["iteration"]
    it["flow_head"]["predict"]["kernel"] *= np.float32(0.1)
    it["flow_head"]["predict"]["bias"] *= np.float32(0.1)
    if "occ_head" in it:
        it["occ_head"]["predict"]["bias"] += np.float32(2.0)
    return v


def test_eval_step_two_legs(family, scene, monkeypatch):
    """The RAFT eval step (weights of :func:`pnp_ready`): network leg
    (flow, occlusion, depth), PnP leg (JAX's flow, occlusion and depth and
    JAX's draws through the port's PnP core: ``pnp_valid`` equal, poses at
    the PnP tests' bound), and the whole step's poses where comparable."""
    from scflow_torch.rendering import Renderer, make_test_meshes
    from scflow_torch.training import make_eval_step as port_eval
    from scflow_tpu.training import make_eval_step

    fam, jmodel, jcfg, variables, _, _ = family
    variables = pnp_ready(variables)
    pmodel, pcfg = port_refiner(variables, iters=ITERS, family=fam)
    renderer, batch = scene
    want = jax.tree.map(np.asarray, make_eval_step(jmodel, renderer, jcfg)(
        variables["params"], variables["batch_stats"], batch))
    n, h, w = want["depth"].shape
    draws = jax_eval_draws(n, h * w)
    monkeypatch.setattr(tflow, "gumbel_draws", lambda *a, **k: draws)
    prenderer = Renderer(make_test_meshes(NUM_CLASS, subdivisions=2,
                                          radius=RADIUS, device="cpu"),
                         image_size=IMAGE)
    got = {k: v.numpy() for k, v in port_eval(pmodel, prenderer, pcfg,
                                              device="cpu")(batch).items()}
    # network leg
    np.testing.assert_allclose(got["depth"], want["depth"], atol=1e-3)
    np.testing.assert_allclose(got["flow"], want["flow"], **FLOW_TOL)
    np.testing.assert_allclose(got["masks"], want["masks"], **OCC_TOL)
    # PnP leg: ``pnp_valid`` equal; fallbacks exactly the reference pose;
    # solved poses held to a float64 witness (the port's core in float64 on
    # the same inputs and draws), as bare EPnP is in test_torch_port_pnp.py:
    # the port no further from it than 2× JAX is, + 0.01° and 0.05 mm. An
    # f32 EPnP hypothesis is ~0.1° off on 6 points, which moves a residual
    # across the 3 px threshold now and then, so f32 runs may pick another
    # winner than float64 does (measured: JAX 0.14° / 0.60 mm from the
    # witness in one sample, the port 8e-5° / 0.015 mm)
    t = torch.from_numpy
    args = [t(want["flow"]), t(want["masks"][..., 0]), t(want["depth"]),
            t(batch["ref_rotations"]), t(batch["ref_translations"]),
            t(batch["k"])]
    leg = tflow.solve_pose_from_flow_core(*draws, *args)
    wit = tflow.solve_pose_from_flow_core(*[d.double() for d in draws],
                                          *[a.double() for a in args])
    valid = want["pnp_valid"]
    np.testing.assert_array_equal(leg["valid"].numpy(), valid)
    for i in np.flatnonzero(~valid):
        assert np.array_equal(leg["rotations"][i].numpy(),
                              batch["ref_rotations"][i])
        assert np.array_equal(want["rotations"][i], batch["ref_rotations"][i])
    wr, wt = wit["rotations"].numpy(), wit["translations"].numpy()
    for r, tt in ((leg["rotations"].numpy(), leg["translations"].numpy()),
                  (want["rotations"], want["translations"])):
        dev = (angle_deg(r[valid], wr[valid]),
               np.linalg.norm(tt[valid] - wt[valid], axis=-1))
        if r is want["rotations"]:
            jax_dev = dev
        else:
            port_dev = dev
    print(f"{fam} PnP leg from the f64 witness: port {port_dev}, JAX "
          f"{jax_dev}")
    assert (port_dev[0] <= 2 * jax_dev[0] + 0.01).all()
    assert (port_dev[1] <= 2 * jax_dev[1] + 0.05).all()
    # whole step (the same draws): equal to the port's core on its own
    # network outputs; where that core picks the winner it picked on JAX's
    # outputs, the pose is the PnP leg's (the flows differ by ≤ 1e-5 px)
    mine = tflow.solve_pose_from_flow_core(
        *draws, t(got["flow"]), t(got["masks"][..., 0]), t(got["depth"]),
        t(batch["ref_rotations"]), t(batch["ref_translations"]),
        t(batch["k"]))
    for key in ("rotations", "translations", "pnp_valid"):
        src = "valid" if key == "pnp_valid" else key
        np.testing.assert_array_equal(got[key], mine[src].numpy())
    fell_back = ~got["pnp_valid"] & ~valid
    same = (got["pnp_valid"] & valid
            & (mine["hypothesis"] == leg["hypothesis"]).numpy())
    for i in np.flatnonzero(fell_back):
        assert np.array_equal(got["rotations"][i], batch["ref_rotations"][i])
    for i in np.flatnonzero(same):
        np.testing.assert_allclose(got["rotations"][i],
                                   leg["rotations"][i].numpy(), atol=1e-4)
        np.testing.assert_allclose(got["translations"][i],
                                   leg["translations"][i].numpy(), rtol=1e-4,
                                   atol=2e-3)
    # elsewhere another near-best hypothesis won (many tie within a count
    # or two here): not compared, only shown (measured 0.57° / 2.6 mm and
    # 0.09° / 0.43 mm)
    both = got["pnp_valid"] & valid
    print(f"{fam} whole step vs JAX where both solved: "
          f"{angle_deg(got['rotations'][both], want['rotations'][both])} deg, "
          f"{np.linalg.norm(got['translations'][both] - want['translations'][both], axis=-1)} mm")
    print(f"{fam}: pnp_valid JAX {valid}, port {got['pnp_valid']}; both "
          f"fell back {fell_back}, same hypothesis {same}")
    if fam == "raft_flow":      # zero occlusions: every pixel is filtered
        assert not valid.any() and fell_back.all()
    else:
        assert valid.all()


def test_pnp_leg_ransac_against_witness(scene, monkeypatch):
    """RANSAC-EPnP on the PnP leg's inputs of ``raft_flow_mask`` (JAX's
    eval-step flow, occlusion and depth under :func:`pnp_ready` weights;
    183 and 426 valid points), each sample with its JAX key, through
    :func:`assert_ransac_like_witness`. Sample 0 is where the port's f32
    EPnP once scored hypothesis 7 at 44 inliers (183 in float64 and in
    JAX), chose hypothesis 15 (147), and Gauss-Newton then lost every
    inlier, so ``pnp_valid`` came out False where JAX's is True."""
    from scflow_tpu.training import make_eval_step

    fam = "raft_flow_mask"
    jmodel, jcfg, variables = jax_raft_variables(fam, iters=ITERS)
    variables = pnp_ready(variables)
    renderer, batch = scene
    want = jax.tree.map(np.asarray, make_eval_step(jmodel, renderer, jcfg)(
        variables["params"], variables["batch_stats"], batch))
    n, h, w = want["depth"].shape
    seen = {}
    core = tflow.ransac_pnp_core

    def spy(noise, p3, p2, k, weights, **kw):
        seen.update(p3=p3, p2=p2, k=k, w=weights)
        return core(noise, p3, p2, k, weights, **kw)

    monkeypatch.setattr(tflow, "ransac_pnp_core", spy)
    t = torch.from_numpy
    tflow.solve_pose_from_flow_core(
        *jax_eval_draws(n, h * w), t(want["flow"]), t(want["masks"][..., 0]),
        t(want["depth"]), t(batch["ref_rotations"]),
        t(batch["ref_translations"]), t(batch["k"]))
    key, _ = jax.random.split(jax.random.PRNGKey(0))
    for i, kk in enumerate(jax.random.split(key, n)):
        p3, p2, k, w_ = (seen[name][i].numpy()
                         for name in ("p3", "p2", "k", "w"))
        got = assert_ransac_like_witness(kk, p3, p2, k, w_)
        assert int(got["num_inliers"]) == int((w_ > 0).sum()), i
        assert want["pnp_valid"][i]


def test_multi_cycle_train_step_refuses_raft(family):
    from scflow_torch.rendering import Renderer, make_test_meshes
    from scflow_torch.training import (build_points_bank, make_optimizer,
                                       make_multi_cycle_train_step)

    _, _, _, _, pmodel, pcfg = family
    bank = make_test_meshes(NUM_CLASS, subdivisions=1, device="cpu")
    with pytest.raises(ValueError, match="SCFlow family only"):
        make_multi_cycle_train_step(
            pmodel, Renderer(bank, image_size=IMAGE),
            build_points_bank(bank, num_points=8), pcfg,
            make_optimizer(pcfg, pmodel.parameters()), device="cpu")


def test_raft_train_step_runs(family, scene):
    """``make_train_step`` dispatches to ``raft_loss``: finite metrics, a
    zero pose loss and moved parameters after one update."""
    from scflow_torch.rendering import Renderer, make_test_meshes
    from scflow_torch.training import (build_points_bank, make_optimizer,
                                       make_train_step)

    fam, _, _, variables, _, _ = family
    pmodel, pcfg = port_refiner(variables, iters=ITERS, family=fam)
    before = [p.detach().clone() for p in pmodel.parameters()]
    bank = make_test_meshes(NUM_CLASS, subdivisions=2, radius=RADIUS,
                            device="cpu")
    step = make_train_step(pmodel, Renderer(bank, image_size=IMAGE),
                           build_points_bank(bank, num_points=8), pcfg,
                           make_optimizer(pcfg, pmodel.parameters()),
                           device="cpu")
    metrics = step(scene[1])
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert metrics["loss_pose"].item() == 0.0 and metrics["loss"].item() > 0
    assert any(not torch.equal(p.detach(), b)
               for p, b in zip(pmodel.parameters(), before))
