"""Every ``ModelConfig`` option of the port against the JAX package on the
CPU.

64² crops, 3 classes, batch 2, 2 GRU iterations, full channel widths.
Weights: the port's seeded init under each option set, through
``to_jax_variables``, with seeded noise on the init-constant leaves
(``perturb``), loaded back with ``load_jax_variables``: the bridge carries
``real_encoder``, the Small and Large widths and the 4-row quaternion
head both ways. JAX renders with the Pallas tile rasterizer in interpret
mode, the port with its plain tile pass.

Option set A is ``separate_encoder``, quaternion rotations, the linear
depth update with the depth not detached in x/y, ``mask_flow``,
``mask_corr`` and ``remat``. Held to JAX:

- the eval step under A, and the refiner's lowres loop under
  ``net_type="Small"``: poses at the JAX package's decoder oracle bound
  (rotations 2e-3; translations rtol 2e-3, atol 2e-4), as
  ``test_torch_port_slice.py``;
- one train step's loss under A (flow and mask terms rtol 1e-4, the pose
  term and the sum 5e-4: see ``LOSS_RTOL``) and its gradient within
  max(1e-3, 5 × JAX's own spread under a 1e-6 change of the rendered
  images), as ``test_torch_port_train.py``;
- the RAFT forward under ``net_type="Small"`` (bilinear upsampling) at
  ``test_torch_port_raft.py``'s flow and occlusion bounds;
- the Large and stride-4 encoders and the quaternion head at
  ``test_torch_port_model.py``'s module bounds;
- ``init_flow`` / ``invalid_flow_num`` at both decoders;
- the flax trees ``to_jax_variables`` writes against the JAX models' own
  (no missing or extra leaf), and the ``separate_encoder`` torch
  checkpoint through JAX's converter with an empty ``missing`` list.

``remat`` is held to the port's decoder without it: the same loss and
gradient in f32 and bf16.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from port_common import nchw, nhwc, perturb
from port_common import one_torch_thread  # noqa: F401 (autouse)

NUM_CLASS = 3
IMAGE = (64, 64)
ITERS = 2
RADIUS = 20.0
NUM_POINTS = 64
POSE_TOL = dict(rot_atol=2e-3, trans_rtol=2e-3, trans_atol=2e-4)
FLOW_TOL = dict(rtol=2e-3, atol=2e-3)
OCC_TOL = dict(atol=1e-3)
ENCODER_TOL = dict(atol=2e-4, rtol=1e-4)
# train-mode loss terms: test_torch_port_train.py's 1e-4, but the pose term
# (and the sum): under A, JAX's f32 pose loss lies 1.9e-4 from the float64
# loss, the port's within 4e-7 of it (``python
# tests/test_torch_port_options.py`` measures both again)
LOSS_RTOL = {"loss": 5e-4, "loss_pose": 5e-4, "loss_flow": 1e-4,
             "loss_mask": 1e-4}
HEAD_TOL = dict(atol=1e-5, rtol=1e-5)

OPTIONS_A = dict(separate_encoder=True, rotation_mode="quaternion",
                 depth_transform="linear", detach_depth_for_xy=False,
                 mask_flow=True, mask_corr=True, remat=True)
OPTION_SETS = {"A": OPTIONS_A, "small": dict(net_type="Small"),
               "large": dict(net_type="Large"),
               "raft_small": dict(family="raft_flow_mask", net_type="Small")}


def configs(options: dict, **model):
    """The (JAX, port) configs of one option set."""
    import scflow_torch.training as pt
    import scflow_tpu.training as jt

    out = []
    for pkg in (jt, pt):
        out.append(pkg.Config(
            model=pkg.ModelConfig(num_class=NUM_CLASS, iters=ITERS,
                                  test_iters=ITERS, **options, **model),
            loss=pkg.LossConfig(num_loss_points=NUM_POINTS),
            optim=pkg.OptimConfig(total_steps=100),
            render=pkg.RenderConfig(image_size=IMAGE)))
    return out


@functools.cache
def bridged(name: str):
    """(JAX model, JAX config, flax variables, port model, port config) of
    an option set, the port's seeded weights perturbed and shared (built
    once per set)."""
    from scflow_torch.training import build_model as port_build
    from scflow_torch.weights import load_jax_variables, to_jax_variables
    from scflow_tpu.training import build_model

    jcfg, pcfg = configs(OPTION_SETS[name])
    pmodel = port_build(pcfg, device="cpu")
    variables = perturb(to_jax_variables(pmodel))
    load_jax_variables(pmodel, variables)
    return build_model(jcfg), jcfg, variables, pmodel, pcfg


def jax_template(jmodel, family: str):
    """The JAX model's own variable shapes (traced, not compiled)."""
    n, (h, w) = 2, IMAGE
    x = jnp.zeros((n, h, w, 3))
    if family != "scflow":
        return jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x)
    eye = jnp.tile(jnp.eye(3), (n, 1, 1))
    return jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), x, x, eye,
        jnp.tile(jnp.asarray([0.0, 0.0, 600.0]), (n, 1)), jnp.zeros((n, h, w)),
        eye, jnp.zeros((n,), jnp.int32))


@pytest.fixture(scope="module")
def scene():
    """JAX's interpret-mode renderer, a synthetic batch (uint8 crops) and
    the batch with JAX's render at the reference pose."""
    from scflow_tpu.data import synthetic_batch
    from scflow_tpu.rendering import Renderer, make_test_meshes
    from scflow_tpu.training import render_at_pose

    renderer = Renderer(make_test_meshes(num_classes=NUM_CLASS,
                                         subdivisions=2, radius=RADIUS),
                        image_size=IMAGE, rasterizer="pallas")
    batch = jax.tree.map(np.asarray, synthetic_batch(
        jax.random.PRNGKey(3), renderer, 2))
    batch["real_images"] = np.round(batch["real_images"] * 255).astype(np.uint8)
    batch["gt_masks"] = batch["gt_masks"].astype(np.uint8)
    images, depth, mask = jax.jit(lambda b: render_at_pose(
        renderer, b["ref_rotations"], b["ref_translations"], b["k"],
        b["labels"], (0.0,) * 3, (255.0,) * 3))(batch)
    rendered = dict(batch, rendered_images=np.asarray(images),
                    rendered_depths=np.asarray(depth),
                    rendered_masks=np.asarray(mask))
    return renderer, batch, rendered


@pytest.fixture(scope="module")
def option_a():
    return bridged("A")


def port_renderer():
    from scflow_torch.rendering import Renderer, make_test_meshes

    return Renderer(make_test_meshes(num_classes=NUM_CLASS, subdivisions=2,
                                     radius=RADIUS, device="cpu"),
                    image_size=IMAGE)


def assert_poses_close(got, want):
    np.testing.assert_allclose(got["rotations"], want["rotations"],
                               atol=POSE_TOL["rot_atol"])
    np.testing.assert_allclose(got["translations"], want["translations"],
                               rtol=POSE_TOL["trans_rtol"],
                               atol=POSE_TOL["trans_atol"])


def test_eval_step_matches_jax(scene, option_a):
    """The eval step under option set A, render to pose."""
    from scflow_torch.training import make_eval_step as port_eval
    from scflow_tpu.training import make_eval_step

    renderer, batch, _ = scene
    jmodel, jcfg, variables, pmodel, pcfg = option_a
    want = jax.tree.map(np.asarray, make_eval_step(jmodel, renderer, jcfg)(
        variables["params"], variables["batch_stats"], batch))
    got = {k: v.numpy() for k, v in port_eval(pmodel, port_renderer(), pcfg,
                                              device="cpu")(batch).items()}
    assert np.abs(want["translations"] - batch["ref_translations"]).max() > 1e-2
    assert_poses_close(got, want)


def test_small_refiner_matches_jax(scene):
    """SCFlow with the Small net (encoders and motion encoder) on JAX's
    rendered inputs, the eval step's lowres loop: every iteration's pose."""
    _, _, rendered = scene
    jmodel, _, variables, pmodel, _ = bridged("small")
    args = [rendered[k] for k in ("rendered_images", "real_images",
                                  "ref_rotations", "ref_translations",
                                  "rendered_depths", "k", "labels")]
    args[1] = (args[1] / np.float32(255.0)).astype(np.float32)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, lowres=True))(
        variables, *args)
    with torch.no_grad():
        got = pmodel(*(torch.from_numpy(np.array(a)) for a in args[:6]),
                     torch.from_numpy(np.array(args[6])).long(), lowres=True)
    assert np.abs(np.asarray(want.translations)[-1]
                  - rendered["ref_translations"]).max() > 1e-2
    assert_poses_close({"rotations": got.rotations.numpy(),
                        "translations": got.translations.numpy()},
                       {"rotations": np.asarray(want.rotations),
                        "translations": np.asarray(want.translations)})


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def port_loss_and_grads(cfg, variables, batch):
    """The port's train-mode ``scflow_loss`` + backward from ``variables``
    under ``cfg``: (metrics, gradient leaves by flax path)."""
    from scflow_torch.training import build_model, build_points_bank, scflow_loss
    from scflow_torch.rendering import make_test_meshes
    from scflow_torch.weights import load_jax_variables, to_jax_variables

    pmodel = build_model(cfg, device="cpu")
    load_jax_variables(pmodel, variables)
    points = build_points_bank(
        make_test_meshes(NUM_CLASS, subdivisions=2, radius=RADIUS,
                         device="cpu"),
        symmetric_classes=(1,), num_points=NUM_POINTS)
    loss, metrics, _ = scflow_loss(
        pmodel, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
        points, cfg, train=True)
    loss.backward()
    grads = flatten_dict(to_jax_variables(pmodel, grad=True)["params"],
                         sep="/")
    return metrics, grads


def test_train_step_loss_and_gradient_match_jax(scene, option_a):
    """Option set A with ``remat``: loss terms and the whole gradient (see
    the module doc; train-mode BN at batch 2 makes it ill-conditioned)."""
    from scflow_tpu.rendering import make_test_meshes
    from scflow_tpu.training import build_points_bank, scflow_loss

    _, _, rendered = scene
    jmodel, jcfg, variables, _, pcfg = option_a
    points = build_points_bank(
        make_test_meshes(num_classes=NUM_CLASS, subdivisions=2,
                         radius=RADIUS),
        symmetric_classes=(1,), num_points=NUM_POINTS)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, s, b: scflow_loss(p, s, b, model=jmodel, points_bank=points,
                                    cfg=jcfg, train=True), has_aux=True))
    (_, (_, want_metrics, _)), want = grad_fn(
        variables["params"], variables["batch_stats"], rendered)
    nudged = dict(rendered, rendered_images=rendered["rendered_images"]
                  * np.float32(1 + 1e-6))
    _, nudged_grads = grad_fn(variables["params"], variables["batch_stats"],
                              nudged)
    metrics, got = port_loss_and_grads(pcfg, variables, rendered)
    for key, rtol in LOSS_RTOL.items():
        np.testing.assert_allclose(metrics[key].detach().numpy(),
                                   np.asarray(want_metrics[key]), rtol=rtol,
                                   err_msg=key)
    want = flatten_dict(jax.tree.map(np.asarray, want), sep="/")
    nudged = flatten_dict(jax.tree.map(np.asarray, nudged_grads), sep="/")
    assert set(got) == set(want)
    assert any(k.startswith("real_encoder/") for k in want)
    keys = sorted(want)

    def flat(tree):
        return np.concatenate([tree[k].ravel() for k in keys])

    spread = rel_err(flat(nudged), flat(want))
    whole = rel_err(flat(got), flat(want))
    print(f"options A gradient: JAX's spread {spread:.2e}, port {whole:.2e}")
    assert whole <= max(1e-3, 5 * spread)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_remat_gives_the_same_loss_and_gradient(scene, option_a, dtype,
                                                monkeypatch):
    """The decoder under A on the train path (full-resolution carry) with
    and without ``remat`` (one checkpoint per iteration, or none): a loss
    over every output and its gradient for every parameter and input
    feature, bit for bit."""
    from scflow_torch.models import decoder as port_decoder

    checkpoints = []

    def counted(*args, **kwargs):
        checkpoints.append(kwargs.get("use_reentrant"))
        return torch.utils.checkpoint.checkpoint(*args, **kwargs)

    monkeypatch.setattr(port_decoder, "checkpoint", counted)
    _, _, rendered = scene
    feats, args = decoder_inputs(rendered)
    options = {k: v for k, v in OPTIONS_A.items() if k != "separate_encoder"}
    runs = []
    for remat in (True, False):
        checkpoints.clear()
        dec = port_decoder.SCFlowDecoder(
            (IMAGE[0] // 8, IMAGE[1] // 8), iters=ITERS, num_class=NUM_CLASS,
            dtype=dtype, **dict(options, remat=remat))
        dec.load_state_dict(option_a[3].decoder.state_dict())
        x = [nchw(f).requires_grad_() for f in feats]
        out = dec(*x, *args)
        loss = sum(getattr(out, f.name).float().square().mean()
                   for f in dataclasses.fields(out))
        loss.backward()
        assert checkpoints == ([False] * ITERS if remat else [])
        runs.append([loss.detach()] + [t.grad for t in x]
                    + [p.grad for p in dec.parameters()])
    assert all(g is not None for g in runs[0])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def test_raft_small_forward_matches_jax():
    """RAFT with the Small net: no convex-weight head, bilinear flow and
    occlusion upsampling."""
    jmodel, _, variables, pmodel, _ = bridged("raft_small")
    assert pmodel.decoder.mask_pred is None
    render, real = rand(2, *IMAGE, 3, seed=3), rand(2, *IMAGE, 3, seed=4)
    flows, occs = jax.jit(jmodel.apply)(variables, render, real)
    with torch.no_grad():
        got_flows, got_occs = pmodel(torch.from_numpy(render),
                                     torch.from_numpy(real))
    assert got_flows.shape == (ITERS, 2, *IMAGE, 2)
    np.testing.assert_allclose(got_flows.numpy(), np.asarray(flows),
                               **FLOW_TOL)
    np.testing.assert_allclose(got_occs.numpy(), np.asarray(occs), **OCC_TOL)


@pytest.mark.parametrize("net_type,stride4", [
    ("Large", False), ("Basic", True)])
def test_encoders_match_jax(option_a, net_type, stride4):
    """The stride-4 encoders (the Small encoder runs in
    ``test_small_refiner_matches_jax``)."""
    from scflow_torch.models.encoder import RAFTEncoder as PortEncoder
    from scflow_tpu.models.encoder import RAFTEncoder

    if net_type == "Basic":
        variables = option_a[2]
    else:
        variables = bridged(net_type.lower())[2]
    params = variables["params"]["render_encoder"]
    enc = PortEncoder(256, norm="in", net_type=net_type, stride4=stride4)
    holder = torch.nn.Module()
    holder.render_encoder = enc
    from scflow_torch.weights import load_jax_variables

    load_jax_variables(holder, {"params": {"render_encoder": params}})
    x = rand(2, 32, 32, 3, seed=5)
    want = jax.jit(RAFTEncoder(256, net_type, norm="in",
                               stride4=stride4).apply)(
        {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = enc(nchw(x))
    assert got.shape[-1] == 32 // enc.stride
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **ENCODER_TOL)


def test_quaternion_pose_head_matches_jax(option_a):
    """The 4-row head (identity bias (0, 0, 0, 1) in the seeded init) and
    ``quaternion_to_matrix`` on its raw, unnormalised outputs."""
    from scflow_torch.geometry import quaternion_to_matrix as port_q2m
    from scflow_torch.models.heads import identity_rotation_bias
    from scflow_tpu.geometry.rotation import quaternion_to_matrix
    from scflow_tpu.models.heads import PoseHead

    _, _, variables, pmodel, _ = option_a
    head = pmodel.decoder.pose_pred
    assert head.rotation_pred.out_features == 4 * NUM_CLASS
    np.testing.assert_array_equal(identity_rotation_bias("quaternion", 2),
                                  [0, 0, 0, 1, 0, 0, 0, 1])
    x = rand(2, 8, 8, head.conv_layers[0].conv.in_channels, seed=6)
    label = np.array([2, 0], np.int32)
    params = variables["params"]["decoder"]["iteration"]["pose_head"]
    want_rot, want_t = jax.jit(PoseHead(NUM_CLASS, "quaternion").apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(label))
    with torch.no_grad():
        rot, trans = head(nchw(x), torch.from_numpy(label).long())
    assert rot.shape == (2, 4)
    np.testing.assert_allclose(rot.numpy(), np.asarray(want_rot), **HEAD_TOL)
    np.testing.assert_allclose(trans.numpy(), np.asarray(want_t), **HEAD_TOL)
    raw = rand(5, 4, seed=7, scale=3.0)
    np.testing.assert_allclose(port_q2m(torch.from_numpy(raw)).numpy(),
                               np.asarray(quaternion_to_matrix(raw)),
                               atol=1e-6)


def decoder_inputs(rendered):
    """Seeded decoder inputs at 64²: NHWC numpy features (render, real,
    GRU state, context) and the port's pose, depth, k and label tensors."""
    hf = IMAGE[0] // 8
    feats = [rand(2, hf, hf, c, seed=10 + i)
             for i, c in enumerate((256, 256, 128, 128))]
    feats[2], feats[3] = np.tanh(feats[2]), np.maximum(feats[3], 0)
    args = [torch.from_numpy(np.array(rendered[k])) for k in (
        "ref_rotations", "ref_translations", "rendered_depths", "k")]
    return feats, args + [torch.from_numpy(np.array(rendered["labels"])).long()]


def test_decoders_take_init_flow_and_invalid_flow_num(scene, option_a):
    """Both decoders from a given initial flow; SCFlow's pose flow with
    ``invalid_flow_num`` on pixels without depth (full-resolution path)."""
    from scflow_tpu.models.decoder import RAFTDecoder, SCFlowDecoder

    _, _, rendered = scene
    _, jcfg, variables, pmodel, _ = option_a
    m = jcfg.model
    hf = IMAGE[0] // 8
    feats, port_args = decoder_inputs(rendered)
    init = rand(2, *IMAGE, 2, seed=20, scale=2.0)
    args = (rendered["ref_rotations"], rendered["ref_translations"],
            rendered["rendered_depths"], rendered["k"], rendered["labels"])
    jdec = SCFlowDecoder(net_type=m.net_type, iters=ITERS, num_class=NUM_CLASS,
                         rotation_mode=m.rotation_mode,
                         depth_transform=m.depth_transform,
                         detach_depth_for_xy=m.detach_depth_for_xy,
                         mask_flow=m.mask_flow, mask_corr=m.mask_corr)
    want = jax.jit(lambda *a: jdec.apply(
        {"params": variables["params"]["decoder"]}, *a, init_flow=init,
        invalid_flow_num=7.0))(*feats, *args)
    with torch.no_grad():
        got = pmodel.decoder(*(nchw(f) for f in feats), *port_args,
                             init_flow=torch.from_numpy(init),
                             invalid_flow_num=7.0)
    assert (rendered["rendered_depths"] == 0).any()
    assert (np.asarray(want.flow_from_pose)[:, rendered["rendered_depths"] == 0]
            == 7.0).all()
    assert_poses_close({"rotations": got.rotations.numpy(),
                        "translations": got.translations.numpy()},
                       {"rotations": np.asarray(want.rotations),
                        "translations": np.asarray(want.translations)})
    np.testing.assert_allclose(got.flow_from_pose.numpy(),
                               np.asarray(want.flow_from_pose), **FLOW_TOL)

    jraft, _, rvars, praft, _ = bridged("raft_small")
    init = rand(2, hf, hf, 2, seed=21)
    want_flows, want_occs = jax.jit(lambda *a: RAFTDecoder(
        net_type="Small", iters=ITERS, predict_mask=True).apply(
        {"params": rvars["params"]["decoder"]}, *a, init_flow=init))(*feats)
    with torch.no_grad():
        flows, occs = praft.decoder(*(nchw(f) for f in feats),
                                    init_flow=torch.from_numpy(init))
    np.testing.assert_allclose(flows.numpy(), np.asarray(want_flows),
                               **FLOW_TOL)
    np.testing.assert_allclose(occs.numpy(), np.asarray(want_occs), **OCC_TOL)


@pytest.mark.parametrize("name", list(OPTION_SETS))
def test_bridged_trees_are_the_jax_models_trees(name):
    """``to_jax_variables`` writes every leaf the JAX model has, in its
    shape, and no other (for A, Small, Large and RAFT Small)."""
    jmodel, jcfg, got, _, _ = bridged(name)
    want = jax_template(jmodel, jcfg.model.family)
    for col in want:
        w = flatten_dict(want[col], sep="/")
        g = flatten_dict(got.get(col, {}), sep="/")
        assert set(g) == set(w), col
        for k in w:
            assert g[k].shape == w[k].shape, f"{col}/{k}"


def test_separate_encoder_checkpoints(option_a, tmp_path):
    """The port's ``state_dict`` through JAX's converter
    (``separate_encoder=True``): no missing leaf, every value the bridge's.
    The port's ``load_torch_checkpoint`` reads a separate-encoder
    checkpoint as it is, and a shared one with the render encoder's
    weights copied into ``real_encoder``."""
    from scflow_torch.training.checkpoint import load_torch_checkpoint
    from scflow_torch.training import build_model as port_build
    from scflow_tpu.training.checkpoint import (convert_torch_checkpoint,
                                                merge_converted)

    jmodel, _, variables, pmodel, pcfg = option_a
    converted = convert_torch_checkpoint(pmodel.state_dict(),
                                         separate_encoder=True)
    merged, report = merge_converted(jax_template(jmodel, "scflow"),
                                     converted, allow_missing=False)
    assert not report["missing"] and not report["unused"]
    for col in variables:
        want = flatten_dict(variables[col], sep="/")
        got = flatten_dict(merged[col], sep="/")
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v,
                                          err_msg=f"{col}/{k}")

    state = pmodel.state_dict()
    shared = {k: v for k, v in state.items()
              if not k.startswith("real_encoder.")}
    for name, ckpt in (("separate", state), ("shared", shared)):
        path = tmp_path / f"{name}.pth"
        torch.save({"state_dict": ckpt}, path)
        fresh = port_build(pcfg, device="cpu", seed=1)
        report = load_torch_checkpoint(str(path), fresh)
        assert not report["unused"]
        assert not [k for k in report["missing"]
                    if not k.endswith("num_batches_tracked")]
        got = fresh.state_dict()
        for k, v in state.items():
            src = k
            if name == "shared" and k.startswith("real_encoder."):
                src = "render_encoder" + k[len("real_encoder"):]
            assert torch.equal(got[k], state[src]), k


@pytest.mark.parametrize("field,value,family", [
    ("net_type", "Large", "raft_flow_mask"), ("net_type", "Huge", "scflow"),
    ("rotation_mode", "euler", "scflow"),
    ("depth_transform", "log", "scflow")])
def test_build_model_refuses_what_neither_package_runs(field, value, family):
    from scflow_torch.training import Config, ModelConfig, build_model

    cfg = Config(model=ModelConfig(family=family, **{field: value}))
    with pytest.raises(ValueError, match=field):
        build_model(cfg, device="cpu")


def test_jax_raft_large_flows_are_twice_the_frame():
    """Why the port refuses RAFT with the Large net: JAX's decoder
    upsamples its stride-4 features by 8 (shapes traced, not computed)."""
    from scflow_tpu.training import build_model

    jcfg, _ = configs(dict(family="raft_flow_mask", net_type="Large"))
    jmodel = build_model(jcfg)
    x = jnp.zeros((2, *IMAGE, 3))
    flows, occs = jax.eval_shape(jmodel.apply,
                                 jax_template(jmodel, "raft_flow_mask"), x, x)
    assert flows.shape == (ITERS, 2, 2 * IMAGE[0], 2 * IMAGE[1], 2)
    assert occs.shape[2:4] == flows.shape[2:4]


def _float64_witness():
    """Print, under option set A, how far JAX's and the port's f32 loss
    terms lie from the port's loss in float64 (the source of
    ``LOSS_RTOL``). The port runs in float64 with ``Tensor.float`` (its f32
    cast points) sending to the default dtype."""
    from scflow_torch.rendering import make_test_meshes as port_meshes
    from scflow_torch.training import build_model, build_points_bank
    from scflow_torch.training import scflow_loss as port_loss
    from scflow_torch.weights import load_jax_variables
    from scflow_tpu.rendering import make_test_meshes
    from scflow_tpu.training import build_points_bank as jax_points
    from scflow_tpu.training import scflow_loss

    _, _, rendered = scene.__wrapped__()
    jmodel, jcfg, variables, _, pcfg = bridged("A")
    points = jax_points(make_test_meshes(num_classes=NUM_CLASS,
                                         subdivisions=2, radius=RADIUS),
                        symmetric_classes=(1,), num_points=NUM_POINTS)
    _, (_, want, _) = jax.jit(lambda p, s, b: scflow_loss(
        p, s, b, model=jmodel, points_bank=points, cfg=jcfg, train=True))(
        variables["params"], variables["batch_stats"], rendered)
    float_cast = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t.to(torch.get_default_dtype())
    terms = {}
    for dt in (torch.float32, torch.float64):
        torch.set_default_dtype(dt)
        model = build_model(pcfg, device="cpu")
        load_jax_variables(model, variables)
        pts = build_points_bank(port_meshes(NUM_CLASS, subdivisions=2,
                                            radius=RADIUS, device="cpu"),
                                symmetric_classes=(1,), num_points=NUM_POINTS)
        pts = dataclasses.replace(pts, **{
            f.name: getattr(pts, f.name).to(dt)
            for f in dataclasses.fields(pts)
            if torch.is_floating_point(getattr(pts, f.name))})
        batch = {k: torch.from_numpy(np.array(v)) for k, v in rendered.items()}
        batch = {k: v.to(dt) if v.is_floating_point() else v
                 for k, v in batch.items()}
        batch["real_images"] = batch["real_images"].to(dt) / 255.0
        batch["gt_masks"] = batch["gt_masks"].to(dt)
        _, metrics, _ = port_loss(model.to(dt), batch, pts, pcfg, train=True)
        terms[dt] = {k: metrics[k].item() for k in LOSS_RTOL}
    torch.Tensor.float = float_cast
    torch.set_default_dtype(torch.float32)
    f64 = terms[torch.float64]
    for key in LOSS_RTOL:
        print(f"{key}: JAX f32 {float(want[key]) / f64[key] - 1:+.2e}, port "
              f"f32 {terms[torch.float32][key] / f64[key] - 1:+.2e} from the "
              "port in float64")


if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _float64_witness()
