"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX. On a machine without JAX, leave out
``tests/conftest.py`` (it imports JAX):

    python -m pytest tests/test_torch_port_kernels.py --noconftest -q -p no:cacheprovider

Without an NVIDIA GPU every test here skips.
"""
import pytest
import torch

from scflow_torch.ops import rasterize_fast as rf
from scflow_torch.ops.fused_norm import (instance_norm, instance_norm_bwd,
                                         instance_norm_bwd_reference,
                                         instance_norm_fwd,
                                         instance_norm_reference)
from scflow_torch.rendering import Renderer, make_test_meshes

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def norm_inputs(dev, c, hw, n=4, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, hw, hw, generator=g) * 2.0 + 0.5
    scale = 1.0 + 0.3 * torch.randn(c, generator=g)
    bias = 0.2 * torch.randn(c, generator=g)
    return x.to(dev, dtype), scale.to(dev), bias.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hw", [(64, 128), (96, 64), (128, 32)])
def test_instance_norm_kernel(dev, dtype, c, hw):
    x, scale, bias = norm_inputs(dev, c, hw, dtype=dtype)
    before = instance_norm_fwd.launches
    got = instance_norm(x, scale, bias)
    torch.cuda.synchronize()
    assert instance_norm_fwd.launches == before + 1
    assert got.dtype == dtype
    want = instance_norm_reference(x, scale, bias).float()
    diff = (got.float() - want).abs()
    if dtype == torch.float32:           # statistics summed in another order
        assert (diff <= 1e-5 + 1e-5 * want.abs()).all()
    else:              # f32 statistics' spread, then one bf16 rounding step
        ulp = (want.abs().clamp_min(2.0 ** -126).log2().floor() - 7).exp2()
        assert (diff <= 1e-5 + ulp).all()


def test_instance_norm_kernel_refuses(dev):
    x, scale, bias = norm_inputs(dev, 8, 16)
    for bad in (x.transpose(2, 3), x.half(), x[:, :, :5, :5].contiguous()):
        with pytest.raises(ValueError):
            instance_norm_fwd(bad, scale, bias)
    with pytest.raises(ValueError):
        instance_norm_fwd(torch.zeros(1, 1, 256, 256, device=dev), scale[:1],
                          bias[:1])


def assert_bwd_close(got, want, x, g):
    """dx within 1e-5 + 1e-5·|ref| in f32 (sums in another order), within
    one bf16 step plus that spread in bf16; dscale and dbias within 1e-5 of
    the sums of their terms' magnitudes, Σ|g·x̂| and Σ|g|."""
    dx, dscale, dbias = got
    want_dx, want_scale, want_bias = want
    assert dx.dtype == x.dtype and dscale.dtype == dbias.dtype == torch.float32
    ref = want_dx.float()
    allow = 1e-5 + 1e-5 * ref.abs()
    if x.dtype == torch.bfloat16:
        allow = 1e-5 + (ref.abs().clamp_min(2.0 ** -126).log2().floor() - 7).exp2()
    assert ((dx.float() - ref).abs() <= allow).all()
    xf = x.float()
    mu = xf.mean((2, 3), keepdim=True)
    xhat = (xf - mu) * torch.rsqrt((xf - mu).square().mean((2, 3), keepdim=True)
                                   + 1e-5)
    for got_s, want_s, terms in ((dscale, want_scale, g.float() * xhat),
                                 (dbias, want_bias, g.float())):
        mag = terms.abs().sum((0, 2, 3))
        assert ((got_s - want_s).abs() <= 1e-5 * mag).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,hw", [(4, 64, 128), (4, 96, 64), (4, 128, 32),
                                    (3, 7, 16), (5, 1, 8)])
def test_instance_norm_bwd_kernel(dev, dtype, n, c, hw):
    x, scale, _ = norm_inputs(dev, c, hw, n=n, dtype=dtype)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).to(
        dev, dtype)
    before = instance_norm_bwd.launches
    got = instance_norm_bwd(x, g, scale)
    again = instance_norm_bwd(x, g, scale)
    torch.cuda.synchronize()
    assert instance_norm_bwd.launches == before + 2
    for a, b in zip(got, again):       # no atomics: the same bits every run
        assert torch.equal(a, b)
    assert_bwd_close(got, instance_norm_bwd_reference(x, g, scale), x, g)


def test_instance_norm_autograd_launches_both_kernels(dev):
    x, scale, bias = norm_inputs(dev, 96, 64)
    x.requires_grad_()
    scale.requires_grad_()
    bias.requires_grad_()
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(6)).to(dev)
    f0, b0 = instance_norm_fwd.launches, instance_norm_bwd.launches
    y = instance_norm(x, scale, bias)
    # a non-contiguous output gradient is made contiguous for the kernel
    y.backward(g.transpose(2, 3).contiguous().transpose(2, 3))
    torch.cuda.synchronize()
    assert (instance_norm_fwd.launches, instance_norm_bwd.launches) == (f0 + 1,
                                                                        b0 + 1)
    want = instance_norm_bwd_reference(x.detach(), g, scale.detach())
    assert_bwd_close((x.grad, scale.grad, bias.grad), want, x.detach(), g)


def test_instance_norm_bwd_kernel_refuses(dev):
    x, scale, _ = norm_inputs(dev, 8, 16)
    g = torch.randn_like(x)
    for bx, bg in ((x, g.transpose(2, 3)), (x, g.bfloat16()),
                   (x.half(), g.half()), (x, g[:1].contiguous()),
                   (x[:, :, :5, :5].contiguous(), g[:, :, :5, :5].contiguous()),
                   (x.cpu(), g.cpu())):
        with pytest.raises(ValueError):
            instance_norm_bwd(bx, bg, scale)
    with pytest.raises(ValueError):
        instance_norm_bwd(x, g, scale[:4])


def scene_inputs(dev, n=8, classes=5, subdivisions=3, size=256, seed=0,
                 k_faces=rf.K_FACES, shift=0.0, big_face=False, d_attr=9):
    """The tile pass's arguments for a seeded scene of ``n`` objects;
    ``shift`` moves them sideways (mm), ``big_face`` turns face 0 of every
    sample into a triangle behind them that covers the whole frame, and
    ``d_attr`` channels of the Phong attributes (repeated past 9) are
    interpolated (0: none, the kernel's no-attribute form)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1)
    from scflow_torch.geometry import quaternion_to_matrix

    rot = quaternion_to_matrix(q)
    t = torch.cat([torch.rand(n, 2, generator=g) * 60 - 30 + shift,
                   torch.rand(n, 1, generator=g) * 400 + 500], dim=-1)
    k = torch.tensor([[500.0, 0, size / 2], [0, 500.0, size / 2], [0, 0, 1]])
    labels = torch.randint(0, classes, (n,), generator=g)
    renderer = Renderer(make_test_meshes(classes, subdivisions=subdivisions,
                                         radius=60.0, device=dev),
                        image_size=(size, size))
    inp = renderer.rasterizer_inputs(rot.to(dev), t.to(dev),
                                     k.expand(n, 3, 3).to(dev), labels.to(dev))
    tri_xy, tri_z, valid = inp["tri_xy"], inp["tri_z"], inp["face_valid"]
    if big_face:
        tri_xy, tri_z, valid = tri_xy.clone(), tri_z.clone(), valid.clone()
        tri_xy[:, 0] = torch.tensor([[-2.0 * size, -2.0 * size],
                                     [4.0 * size, -2.0 * size],
                                     [-2.0 * size, 4.0 * size]])
        tri_z[:, 0] = 2000.0
        valid[:, 0] = True
    tri_attrs = (torch.cat([inp["tri_attrs"]] * 2, dim=-1)[..., :d_attr]
                 if d_attr else None)
    coeff, bbox, attr, d, k_faces = rf.tile_inputs(
        tri_xy, tri_z, valid, size, size, tri_attrs, k_faces)
    return coeff, bbox, attr, size, size, d, k_faces


def rasterize_both(args):
    """The kernel's outputs, after checking it launched once, and the plain
    version's."""
    before = rf.rasterize_tiles.launches
    got = rf.rasterize_tiles(*args)
    torch.cuda.synchronize()
    assert rf.rasterize_tiles.launches == before + 1
    return got, rf.rasterize_tiles_reference(*args)


def assert_bit_equal(got, want):
    # the same unfused f32 arithmetic in the same order, the same selection
    for name, a, b in zip(("face_id", "zbuf", "attrs"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


@pytest.mark.parametrize("subdivisions,k_faces,n", [
    (3, 256, 8), (1, 256, 8), (3, 64, 8), (4, 256, 8), (3, 256, 1),
    (3, 256, 32)])
def test_rasterize_kernel(dev, subdivisions, k_faces, n):
    got, want = rasterize_both(scene_inputs(dev, n=n, subdivisions=subdivisions,
                                            k_faces=k_faces))
    assert (want[0] >= 0).any()
    assert_bit_equal(got, want)


# 9 (Phong) has its own instantiation; 3 (Gouraud, flat), 5 and 16 take
# the generic one
@pytest.mark.parametrize("d_attr", [3, 5, 16])
def test_rasterize_kernel_attribute_widths(dev, d_attr):
    got, want = rasterize_both(scene_inputs(dev, d_attr=d_attr))
    assert want[2].shape[-1] == d_attr and (want[0] >= 0).any()
    assert_bit_equal(got, want)


@pytest.mark.parametrize("n,size,big_face", [
    (8, 256, False), (32, 256, False), (2, 256, True)],
    ids=["batch8", "batch32", "frame-filling-face"])
def test_rasterize_kernel_without_attributes(dev, n, size, big_face):
    """The no-attribute instantiation: face ids and z bit-equal to the
    plain version and to the attribute form's, no attribute output."""
    args = scene_inputs(dev, n=n, size=size, big_face=big_face, d_attr=0)
    assert args[2] is None and args[5] == 0
    got, want = rasterize_both(args)
    assert got[2].shape == (n, size, size, 0) and (want[0] >= 0).any()
    assert_bit_equal(got, want)
    phong, _ = rasterize_both(scene_inputs(dev, n=n, size=size,
                                           big_face=big_face))
    assert_bit_equal(got[:2], phong[:2])


def test_renderer_depth_and_mask_only(dev):
    """``render_image=False`` launches the no-attribute form; its depth and
    mask equal the full render's, and the soft silhouette the CPU's."""
    bank = make_test_meshes(3, subdivisions=2, radius=60.0, device=dev)
    rot = torch.eye(3, device=dev).expand(2, 3, 3)
    t = torch.tensor([[0.0, 0.0, 600.0], [10.0, -5.0, 700.0]], device=dev)
    k = torch.tensor([[300.0, 0, 64], [0, 300.0, 64], [0, 0, 1]],
                     device=dev).expand(2, 3, 3)
    labels = torch.tensor([0, 1], device=dev)
    full = Renderer(bank, image_size=(128, 128))(rot, t, k, labels)
    opts = dict(render_image=False, render_mask=True, soft_blending=True)
    before = rf.rasterize_tiles.launches
    out = Renderer(bank, image_size=(128, 128), **opts)(rot, t, k, labels)
    torch.cuda.synchronize()
    assert rf.rasterize_tiles.launches == before + 1
    assert "images" not in out and out["mask"].any()
    assert torch.equal(out["mask"], full["mask"])
    assert torch.equal(out["depth"].view(torch.int32),
                       full["depth"].view(torch.int32))
    cpu = Renderer(bank.to("cpu"), image_size=(128, 128), **opts)(
        rot.cpu(), t.cpu(), k.cpu(), labels.cpu())
    assert torch.equal(out["mask"].cpu(), cpu["mask"])
    assert (out["masks"].cpu() - cpu["masks"]).abs().max() <= 1e-4


@pytest.mark.parametrize("case", ["off_frame", "invalid"])
def test_rasterize_kernel_all_background(dev, case):
    args = scene_inputs(dev, shift=2000.0 if case == "off_frame" else 0.0)
    if case == "invalid":                        # boxes overlap, no face is ok
        coeff = args[0].clone()
        coeff[..., 14] = 0.0
        args = (coeff, *args[1:])
    got, want = rasterize_both(args)
    assert (want[0] == -1).all()
    assert_bit_equal(got, want)


def test_rasterize_kernel_frame_filling_face(dev):
    got, want = rasterize_both(scene_inputs(dev, big_face=True))
    assert (want[0] >= 0).all() and (want[0] > 0).any()
    assert_bit_equal(got, want)


def test_rasterize_fast_selects_in_kernel(dev, monkeypatch):
    def no_torch_selection(*args, **kwargs):
        raise AssertionError("torch selection on the CUDA path")

    monkeypatch.setattr(rf, "_select_tiles", no_torch_selection)
    renderer = Renderer(make_test_meshes(3, subdivisions=2, radius=60.0,
                                         device=dev), image_size=(128, 128))
    rot = torch.eye(3, device=dev).expand(2, 3, 3)
    t = torch.tensor([[0.0, 0.0, 600.0], [10.0, -5.0, 700.0]], device=dev)
    k = torch.tensor([[300.0, 0, 64], [0, 300.0, 64], [0, 0, 1]],
                     device=dev).expand(2, 3, 3)
    before = rf.rasterize_tiles.launches
    out = renderer(rot, t, k, torch.tensor([0, 1], device=dev))
    torch.cuda.synchronize()
    assert rf.rasterize_tiles.launches == before + 1
    assert out["mask"].any() and torch.isfinite(out["images"]).all()


def test_rasterize_kernel_refuses(dev):
    coeff, bbox, attr, h, w, d, k = scene_inputs(dev, n=1, subdivisions=1)
    misaligned = torch.empty(coeff.numel() + 1, device=dev)[1:].view(
        coeff.shape).copy_(coeff)
    for bad in ((coeff.double(), bbox, attr, h, w, d, k),
                (coeff, bbox[..., :3].contiguous(), attr, h, w, d, k),
                (coeff, bbox, attr.transpose(1, 2).contiguous().transpose(1, 2), h,
                 w, d, k),
                (coeff, bbox.cpu(), attr, h, w, d, k),
                (misaligned, bbox, attr, h, w, d, k),
                (coeff, bbox, attr, 250, w, d, k),
                (coeff, bbox, attr, h, w, 17, k),
                (coeff, bbox, attr, h, w, 0, k),
                (coeff, bbox, None, h, w, d, k),
                (coeff, bbox, attr, h, w, d, 12),
                (coeff, bbox, attr, h, w, d, 264),
                (coeff[:, :-4].contiguous(), bbox[:, :-4].contiguous(),
                 attr[:, :-4].contiguous(), h, w, d, k)):
        with pytest.raises(ValueError):
            rf.rasterize_tiles(*bad)


def test_synthetic_batch_same_on_both_devices(dev):
    from scflow_torch.data import synthetic_batch

    batches = [synthetic_batch(torch.Generator().manual_seed(3),
                               Renderer(make_test_meshes(3, subdivisions=2,
                                                         radius=20.0,
                                                         device=d),
                                        image_size=(64, 64)), 4)
               for d in ("cpu", dev)]
    for k, v in batches[0].items():
        got = batches[1][k].cpu()
        if k in ("real_images", "gt_masks"):
            # two renders: the card's K1 and shading against the CPU's
            # plain versions round differently; silhouettes may move a pixel
            assert ((got - v).abs() > 1e-3).float().mean() < 0.01, k
        else:                                      # poses drawn on the CPU
            assert torch.equal(got, v), k


def _small_batch(dev_renderer, n=2):
    from scflow_torch.data import synthetic_batch

    return synthetic_batch(torch.Generator().manual_seed(3), dev_renderer, n)


def _port_setup(device, **model):
    from scflow_torch.training import (Config, ModelConfig, RenderConfig,
                                       build_model)

    cfg = Config(model=ModelConfig(num_class=3, iters=2, test_iters=2,
                                   **model),
                 render=RenderConfig(image_size=(64, 64)))
    renderer = Renderer(make_test_meshes(3, subdivisions=2, radius=20.0,
                                         device=device), image_size=(64, 64))
    return build_model(cfg, device=device, seed=0), cfg, renderer


def test_bf16_eval_step_card_vs_cpu(dev):
    """The bf16 eval step (64², 3 classes, 2 samples) on the card against
    the CPU: poses within 3× the CPU's own bf16-vs-f32 gap, every K2 input
    bf16."""
    from scflow_torch.training import make_eval_step

    outs = {}
    batch = None
    for device, dtype in (("cpu", "float32"), ("cpu", "bfloat16"),
                          (dev, "bfloat16")):
        model, cfg, renderer = _port_setup(device, dtype=dtype)
        if batch is None:
            batch = _small_batch(renderer)
        before = instance_norm_fwd.launches
        outs[(str(device), dtype)] = {
            k: v.cpu() for k, v in make_eval_step(model, renderer, cfg,
                                                  device=device)(batch).items()}
        if device != "cpu":
            assert instance_norm_fwd.launches - before == 30
    cpu32, cpu16 = outs[("cpu", "float32")], outs[("cpu", "bfloat16")]
    card16 = outs[(str(dev), "bfloat16")]
    for key in ("rotations", "translations"):
        gap = (cpu16[key] - cpu32[key]).abs().max()
        assert gap > 0, key
        assert (card16[key] - cpu16[key]).abs().max() <= 3 * gap, key


@pytest.mark.parametrize("family", ["raft_flow_mask", "raft_flow"])
def test_raft_network_card_vs_cpu(dev, family):
    """The RAFT network (64², 3 iterations, 2 samples) on the card against
    the CPU on the same rendered and real images (the CPU's render): flows
    rtol/atol 2e-3, occlusions atol 1e-3 (the CPU tests' bounds against
    JAX); the eval step on the card launches K1 once and K2 30 times."""
    from scflow_torch.training import (device_normalize_images,
                                       make_eval_step, render_at_pose)

    model, cfg, renderer = _port_setup("cpu", family=family)
    batch = _small_batch(renderer)
    with torch.no_grad():
        rendered, _, _ = render_at_pose(
            renderer, batch["ref_rotations"], batch["ref_translations"],
            batch["k"], batch["labels"].long(), cfg.data.normalize_mean,
            cfg.data.normalize_std)
        real = device_normalize_images(batch["real_images"], cfg)
        cpu = model(rendered, real)
        card_model, _, card_renderer = _port_setup(dev, family=family)
        card = card_model(rendered.to(dev), real.to(dev))
    torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(card[1].cpu(), cpu[1], rtol=0, atol=1e-3)
    k1, k2 = rf.rasterize_tiles.launches, instance_norm_fwd.launches
    out = make_eval_step(card_model, card_renderer, cfg, device=dev)(batch)
    assert rf.rasterize_tiles.launches - k1 == 1
    assert instance_norm_fwd.launches - k2 == 30
    assert torch.isfinite(out["rotations"]).all()
