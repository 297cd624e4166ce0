"""The port's bf16 compute path (``ModelConfig.dtype="bfloat16"``) against
the JAX package's (flax modules with ``dtype=jnp.bfloat16``) on the CPU.

64² inputs, 3 classes, batch 2, full channel widths, the JAX init with
seeded noise bridged into the port (parameters stay f32 on both sides).

Per module the outputs agree to a few bf16 steps of the output's scale:
|port − JAX| ≤ n · 2^(⌊log2 max|JAX|⌋ − 7) elementwise. The two sides
round at other points: XLA on the CPU keeps fused bf16 elementwise chains
(bias adds, GRU gates, residual adds) in f32 and rounds once, torch rounds
after every op, and the convolutions sum in other orders before their one
rounding. n is stated per test (single layers 2-4, stacks more).

Whole steps are held to JAX's own bf16-vs-f32 gap: the port's bf16 result
differs from JAX's bf16 result by at most a stated multiple of the gap
between JAX's bf16 and f32 results.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_common import IMAGE, NUM_CLASS, jax_refiner_variables, nchw
from port_common import one_torch_thread  # noqa: F401 (autouse)
from scflow_torch.models import corr as tcorr
from scflow_torch.models import layers as tlayers
from scflow_tpu.models import corr as jcorr
from scflow_tpu.models import layers as jlayers
from scflow_tpu.models.gru import ConvGRU
from scflow_tpu.models.heads import FlowMaskEmbed, MotionEncoder, PoseHead, XHead

BF16 = jnp.bfloat16
FEAT = 8                      # feature map side at 64² inputs
ITERS = 2
RADIUS = 20.0


def port_bf16(variables, iters=ITERS):
    from scflow_torch.training import (Config, ModelConfig, RenderConfig,
                                       build_model)
    from scflow_torch.weights import load_jax_variables

    cfg = Config(model=ModelConfig(num_class=NUM_CLASS, iters=iters,
                                   test_iters=iters, dtype="bfloat16"),
                 render=RenderConfig(image_size=IMAGE))
    model = build_model(cfg, device="cpu")
    load_jax_variables(model, variables)
    return model, cfg


@pytest.fixture(scope="module")
def models():
    _, _, variables = jax_refiner_variables(iters=ITERS)
    tmodel, _ = port_bf16(variables)
    return variables, tmodel


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def bf16_steps(got: torch.Tensor, want) -> float:
    """max |got − want| in bf16 steps of max |want|."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got.float().numpy() - want).max() / step)


def check(got, want, n: float, what: str):
    steps = bf16_steps(got, want)
    print(f"{what}: {steps:.2f} bf16 steps of the output scale (bound {n})")
    assert steps <= n, what


def _iteration(variables, name):
    return {"params": variables["params"]["decoder"]["iteration"][name]}


def _load_conv_block(block, tree: dict, stats: dict | None = None):
    """Fill a port ConvBlock from the flax ConvBlock subtree."""
    state = {"conv.weight": tree["conv"]["kernel"].transpose(3, 2, 0, 1),
             "conv.bias": tree["conv"]["bias"]}
    if block.norm:
        state[f"{block.norm}.weight"] = tree["norm"]["scale"]
        state[f"{block.norm}.bias"] = tree["norm"]["bias"]
    if stats is not None:
        state[f"{block.norm}.running_mean"] = stats["norm"]["mean"]
        state[f"{block.norm}.running_var"] = stats["norm"]["var"]
    block.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in state.items()}, strict=False)


# (norm, flax subtree, input channels, output channels, kernel, stride)
BLOCKS = {
    "in": ("render_encoder", "stem", 3, 64, 7, 2),
    "bn": ("context", "stem", 3, 64, 7, 2),
    "bn_train": ("context", "stem", 3, 64, 7, 2),
    "gn": ("decoder", "pose_head/conv0", 224, 128, 3, 2),
}


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_conv_block(models, kind):
    """conv (bf16 in, weight, bias and out) → norm (f32 statistics and
    normalisation, one rounding) → ReLU; train-mode BN with a sample mask
    also moves the running statistics as flax does (f32, rtol 1e-5)."""
    variables, _ = models
    top, sub, cin, cout, k, stride = BLOCKS[kind]
    norm = kind[:2]
    params, stats = variables["params"][top], variables["batch_stats"]
    stats = stats.get(top)
    if top == "decoder":
        params = params["iteration"]
    for part in sub.split("/"):
        params = params[part]
        stats = stats[part] if stats is not None else None
    side = 64 if cin == 3 else FEAT
    x = rand(2, side, side, cin, seed=1, scale=2.0)
    train = kind == "bn_train"
    mask = np.array([1.0, 0.0], np.float32)
    block = jlayers.ConvBlock(cout, (k, k), stride, norm=norm, dtype=BF16)
    jvars = {"params": params}
    if stats is not None:
        jvars["batch_stats"] = stats
    if train:
        want, upd = block.apply(jvars, jnp.asarray(x), True,
                                jnp.asarray(mask), mutable=["batch_stats"])
    else:
        want = block.apply(jvars, jnp.asarray(x))
    port = tlayers.ConvBlock(cin, cout, k, stride, norm=norm,
                             dtype=torch.bfloat16)
    _load_conv_block(port, params, stats)
    port.train(train)
    with torch.set_grad_enabled(False):
        bn = getattr(port, norm)
        got = port.conv(nchw(x))
        got = torch.relu(bn(got, torch.from_numpy(mask)) if train else bn(got))
    assert got.dtype == torch.bfloat16 and want.dtype == BF16
    check(got, np.moveaxis(np.asarray(want.astype(jnp.float32)), -1, 1), 3,
          f"ConvBlock[{kind}]")
    if train:
        for name in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(bn, f"running_{name}").numpy(),
                np.asarray(upd["batch_stats"]["norm"][name]), rtol=1e-5,
                atol=1e-6)


def test_basic_block(models):
    """The stride-2 block with a downsample (IN): two bf16 convs, three
    norms and the residual add."""
    variables, tmodel = models
    x = rand(2, 32, 32, 64, seed=2)
    want = jlayers.BasicBlock(96, 2, "in", dtype=BF16).apply(
        {"params": variables["params"]["render_encoder"]["layer2_block0"]},
        jnp.asarray(x, BF16))
    with torch.no_grad():
        got = tmodel.render_encoder.res_layer2[0](nchw(x).bfloat16())
    check(got, np.moveaxis(np.asarray(want.astype(jnp.float32)), -1, 1), 4,
          "BasicBlock")


@pytest.mark.parametrize("which", ["render_encoder", "context"])
def test_encoder(models, which):
    """The 15-layer encoders, input cast to bf16 (measured ≤ 3 steps)."""
    from scflow_tpu.models.encoder import RAFTEncoder

    variables, tmodel = models
    x = rand(2, 64, 64, 3)
    enc = RAFTEncoder(256, norm="in" if which == "render_encoder" else "bn",
                      dtype=BF16)
    jvars = {"params": variables["params"][which]}
    if which == "context":
        jvars["batch_stats"] = variables["batch_stats"]["context"]
    want = enc.apply(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = getattr(tmodel, which)(nchw(x))
    assert got.dtype == torch.bfloat16
    check(got, np.moveaxis(np.asarray(want.astype(jnp.float32)), -1, 1), 8,
          which)


def test_motion_encoder(models):
    variables, tmodel = models
    corr, flow = rand(2, FEAT, FEAT, 324, seed=4), rand(2, FEAT, FEAT, 2, seed=5)
    want = MotionEncoder(dtype=BF16).apply(_iteration(variables, "motion"),
                                           jnp.asarray(corr), jnp.asarray(flow))
    with torch.no_grad():
        got = tmodel.decoder.encoder(nchw(corr), nchw(flow))
    assert got.dtype == torch.bfloat16
    check(got, np.moveaxis(np.asarray(want.astype(jnp.float32)), -1, 1), 4,
          "MotionEncoder")


def test_conv_gru(models):
    """Two chained bf16 GRU passes; XLA keeps each pass's gate arithmetic
    in f32, torch rounds after every op (measured ≤ 1.5 steps)."""
    variables, tmodel = models
    h = rand(2, FEAT, FEAT, 128, seed=6)
    x = rand(2, FEAT, FEAT, 256, seed=7)
    want = ConvGRU(128, dtype=BF16).apply(
        _iteration(variables, "gru"), jnp.asarray(h, BF16), jnp.asarray(x, BF16))
    with torch.no_grad():
        got = tmodel.decoder.gru(nchw(h).bfloat16(), nchw(x).bfloat16())
    assert got.dtype == torch.bfloat16
    check(got, np.moveaxis(np.asarray(want.astype(jnp.float32)), -1, 1), 4,
          "ConvGRU")


@pytest.mark.parametrize("name,port,cin,head", [
    ("flow_head", "flow_pred", 128, lambda: XHead((256,), 2, "flow",
                                                 dtype=BF16)),
    ("mask_head", "mask_pred", 128, lambda: XHead((256,), 1, "mask",
                                                 dtype=BF16)),
    ("dflow_embed", "delta_flow_encoder", 2,
     lambda: FlowMaskEmbed((128, 64), (7, 3), dtype=BF16)),
    ("mask_embed", "mask_encoder", 1,
     lambda: FlowMaskEmbed((64, 32), (3, 3), dtype=BF16)),
])
def test_conv_heads(models, name, port, cin, head):
    """XHead: bf16 hidden conv, f32 predict conv on its output (f32 out);
    FlowMaskEmbed: input cast to bf16, bf16 convs."""
    variables, tmodel = models
    x = rand(2, FEAT, FEAT, cin, seed=8)
    xin = jnp.asarray(x, BF16) if "head" in name else jnp.asarray(x)
    want = head().apply(_iteration(variables, name), xin)
    with torch.no_grad():
        got = getattr(tmodel.decoder, port)(
            nchw(x).bfloat16() if "head" in name else nchw(x))
    assert got.dtype == ((torch.float32 if "head" in name
                          else torch.bfloat16))
    check(got, np.moveaxis(np.asarray(want.astype(jnp.float32)), -1, 1), 3,
          name)


def test_pose_head(models):
    """bf16 GN convs and FC layers, f32 rotation/translation outputs."""
    variables, tmodel = models
    x = rand(3, FEAT, FEAT, 224, seed=9)
    label = np.array([2, 0, 1], np.int32)
    want = PoseHead(3, "ortho6d", dtype=BF16).apply(
        _iteration(variables, "pose_head"), jnp.asarray(x, BF16),
        jnp.asarray(label))
    with torch.no_grad():
        got = tmodel.decoder.pose_pred(nchw(x).bfloat16(),
                                       torch.from_numpy(label).long())
    for g, w, what in zip(got, want, ("rotation", "translation")):
        assert g.dtype == torch.float32
        check(g, w, 4, f"PoseHead {what}")


@pytest.mark.parametrize("hw", [FEAT, 32])     # 32: the 256² pyramid
def test_pyramid_and_lookup(hw):
    """bf16 features: f32 accumulation, scaling and pooling, levels stored
    in bf16 (as the JAX decoder casts them); then the bf16 lookup (bf16
    weights, x taps summed in f32 and rounded, y taps summed in f32), f32
    out."""
    fr = rand(2, hw, hw, 256, seed=1).astype(jnp.bfloat16)
    fo = rand(2, hw, hw, 256, seed=2).astype(jnp.bfloat16)
    flow = rand(2, hw, hw, 2, seed=3, scale=3.0)
    want = [p.astype(BF16) for p in jcorr.correlation_pyramid_pm(
        jnp.asarray(fr), jnp.asarray(fo), 4)]
    got = tcorr.correlation_pyramid(
        nchw(np.asarray(fr, np.float32)).bfloat16(),
        nchw(np.asarray(fo, np.float32)).bfloat16(), 4, torch.bfloat16)
    for w, g in zip(want, got):     # JAX (N, Hl, Wl, P), port (N, P, Hl, Wl)
        assert g.dtype == torch.bfloat16
        check(g, np.asarray(w.astype(jnp.float32)).transpose(0, 3, 1, 2), 1,
              f"pyramid level {g.shape[-1]}²")
    want = jcorr.corr_lookup_pm(want, jnp.asarray(flow), radius=4)
    got = tcorr.corr_lookup(got, nchw(flow), radius=4)
    assert got.dtype == torch.float32
    check(got, np.moveaxis(np.asarray(want), -1, 1), 2, "bf16 lookup")


# ---------------------------------------------------------------- whole steps


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
    return renderer, batch


def _jax_model(dtype: str):
    from scflow_tpu.training import build_model

    model, cfg, variables = jax_refiner_variables(iters=ITERS)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             dtype=dtype))
    return build_model(cfg), cfg, variables


def _port_renderer():
    from scflow_torch.rendering import Renderer, make_test_meshes

    return Renderer(make_test_meshes(num_classes=NUM_CLASS, subdivisions=2,
                                     radius=RADIUS, device="cpu"),
                    image_size=IMAGE)


def test_eval_step_bf16(scene):
    """The lowres eval step in bf16: the port's poses, flow and mask within
    3× JAX's bf16-vs-f32 gap of JAX's bf16 results (+ 1e-5 of each
    output's scale)."""
    from scflow_torch.training import make_eval_step as port_eval
    from scflow_tpu.training import make_eval_step

    renderer, batch = scene
    outs = {}
    for dtype in ("float32", "bfloat16"):
        model, cfg, variables = _jax_model(dtype)
        step = make_eval_step(model, renderer, cfg)
        outs[dtype] = jax.tree.map(np.asarray, step(
            variables["params"], variables["batch_stats"], batch))
    tmodel, pcfg = port_bf16(variables)
    got = {k: v.numpy() for k, v in port_eval(tmodel, _port_renderer(), pcfg,
                                              device="cpu")(batch).items()}
    assert np.abs(outs["bfloat16"]["translations"]
                  - batch["ref_translations"]).max() > 1e-2
    for key in ("rotations", "translations", "flow", "masks"):
        gap = np.abs(outs["bfloat16"][key] - outs["float32"][key]).max()
        err = np.abs(got[key] - outs["bfloat16"][key]).max()
        floor = 1e-5 * np.abs(outs["bfloat16"][key]).max()
        print(f"eval bf16 {key}: port−JAX {err:.3g}, JAX bf16−f32 gap "
              f"{gap:.3g}")
        assert gap > 0, key            # bf16 really ran on both sides
        assert err <= 3 * gap + floor, key


def test_scflow_loss_bf16(scene):
    """The train-mode loss terms in bf16 (train-mode BN, 2 iterations,
    full-res flow) on JAX's rendered inputs: each within 3× JAX's own
    bf16-vs-f32 gap (relative, the largest over the terms) of JAX's bf16
    term."""
    from scflow_torch.training import scflow_loss as port_loss
    from scflow_tpu.training import (LossConfig, build_points_bank,
                                     render_at_pose, scflow_loss)

    renderer, batch = scene
    from scflow_tpu.rendering import make_test_meshes

    points = build_points_bank(make_test_meshes(num_classes=NUM_CLASS,
                                                subdivisions=2, radius=RADIUS),
                               symmetric_classes=(1,), num_points=64)
    terms = {}
    for dtype in ("float32", "bfloat16"):
        model, cfg, variables = _jax_model(dtype)
        cfg = dataclasses.replace(cfg, loss=LossConfig(num_loss_points=64))
        images, depth, mask = jax.jit(lambda b: render_at_pose(
            renderer, b["ref_rotations"], b["ref_translations"], b["k"],
            b["labels"], cfg.data.normalize_mean,
            cfg.data.normalize_std))(batch)
        full = dict(batch, rendered_images=np.asarray(images),
                    rendered_depths=np.asarray(depth),
                    rendered_masks=np.asarray(mask))
        _, (_, metrics, _) = jax.jit(lambda p, s, b: scflow_loss(
            p, s, b, model=model, points_bank=points, cfg=cfg, train=True))(
                variables["params"], variables["batch_stats"], full)
        terms[dtype] = {k: np.asarray(v) for k, v in metrics.items()}

    from scflow_torch.rendering import make_test_meshes as port_meshes
    from scflow_torch.training import LossConfig as PortLoss
    from scflow_torch.training import build_points_bank as port_points

    tmodel, pcfg = port_bf16(variables)
    pcfg = dataclasses.replace(pcfg, loss=PortLoss(num_loss_points=64))
    ppoints = port_points(port_meshes(NUM_CLASS, subdivisions=2,
                                      radius=RADIUS, device="cpu"),
                          symmetric_classes=(1,), num_points=64)
    _, metrics, _ = port_loss(
        tmodel, {k: torch.from_numpy(np.array(v)) for k, v in full.items()},
        ppoints, pcfg, train=True)
    keys = ("loss", "loss_pose", "loss_flow", "loss_mask", "seq_pose_loss",
            "seq_flow_loss", "seq_mask_loss")
    # a scalar's own gap can vanish by cancellation (the flow L1 averages
    # the flow's bf16 errors): take the terms' largest relative gap
    rel_gap = max(np.abs(terms["bfloat16"][k] / terms["float32"][k] - 1).max()
                  for k in keys)
    for key in keys:
        want = terms["bfloat16"][key]
        rel = np.abs(metrics[key].detach().numpy() / want - 1).max()
        print(f"loss bf16 {key}: port−JAX {rel:.3g} relative; JAX's largest "
              f"relative bf16−f32 gap {rel_gap:.3g}")
        assert rel <= 3 * rel_gap, key
