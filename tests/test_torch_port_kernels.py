"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX. On a machine without JAX, leave out
``tests/conftest.py`` (it imports JAX):

    python -m pytest tests/test_torch_port_kernels.py --noconftest -q -p no:cacheprovider

Without an NVIDIA GPU every test here skips.
"""
import math
import time

import pytest
import torch

from scflow_torch.ops import rasterize_fast as rf
from scflow_torch.ops.fused_norm import (instance_norm,
                                         instance_norm_bwd,
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
    """Only the layout, type and device: every plane size is taken."""
    x, scale, bias = norm_inputs(dev, 8, 16)
    for bad in (x.transpose(2, 3), x.half(), x[0], x.cpu()):
        with pytest.raises(ValueError):
            instance_norm_fwd(bad, scale, bias)
    with pytest.raises(ValueError):
        instance_norm_fwd(x, scale[:4], bias[:4])


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
                   (x.cpu(), g.cpu())):
        with pytest.raises(ValueError):
            instance_norm_bwd(bx, bg, scale)
    with pytest.raises(ValueError):
        instance_norm_bwd(x, g, scale[:4])


# planes the JAX function takes beside the encoders': ResNet-50's at 224²
# (7², 14², 28²), odd ones, one element, the warp form's cap (16×32 at an
# offset) and the first plane past it (23²), planes larger than one CTA's
# shared memory (the 240² and 256² stems of 480- and 512-pixel crops, the
# half-resolution plane of a 480×640 frame: the cluster form), planes past
# a cluster (700², 1024²: the split form), and 700² of values 1e3 ± 1
# (n, c, h, w[, loc]: values loc ± 1, loc ± LOC_SPREAD_BF16 in bf16)
# the kernel's documented limits: one CTA stages at most 57,344 f32
# elements; a cluster of 8 CTAs at most 8 times that; a warp holds at most
# 512 (16 a lane)
ONE_CTA_PLANE, CLUSTER_PLANE, WARP_PLANE = 56 * 1024, 8 * 56 * 1024, 512
ANY_PLANES = [(2, 64, 7, 7), (2, 32, 14, 14), (2, 16, 28, 28), (3, 5, 13, 17),
              (2, 3, 1, 1), (1, 2, 5, 5), (1, 3, 240, 240), (1, 2, 256, 256),
              (1, 2, 240, 320), (1, 1, 700, 700), (2, 4, 16, 32),
              (2, 4, 23, 23), (1, 2, 1024, 1024), (1, 1, 700, 700, 1e3)]
FORMS = ("vector", "general", "cluster", "split", "warp")
# bf16's step at 1e3 is 4: 1e3 ± 1 would round to a constant plane (a
# variance of 0, which checks nothing), 1e3 ± 64 keeps 33 distinct values
LOC_SPREAD_BF16 = 64.0


def offset_view(t, offset):
    """``t``'s values in a contiguous view whose storage starts ``offset``
    elements into a fresh buffer (a base that is not 16-byte aligned)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def expected_form(hw, offset):
    """The form the entry picks, restated from its documented limits."""
    if hw > CLUSTER_PLANE:
        return "split"
    if hw > ONE_CTA_PLANE:
        return "cluster"
    if hw % 8 == 0 and not offset:
        return "vector"
    return "warp" if hw <= WARP_PLANE else "general"


def norm64(x, g, scale, bias, shift=0.0, eps=1e-5):
    """Forward and backward in float64 with each plane's mean moved by
    ``shift``: y, dx, dscale, dbias."""
    x64, g64 = x.double(), g.double()
    mu = x64.mean((2, 3), keepdim=True) + shift
    inv = torch.rsqrt(((x64 - mu) ** 2).mean((2, 3), keepdim=True) + eps)
    xhat = (x64 - mu) * inv
    s = scale.double()[:, None, None]
    gs = g64 * s
    dx = inv * (gs - gs.mean((2, 3), keepdim=True)
                - xhat * (gs * xhat).mean((2, 3), keepdim=True))
    return (xhat * s + bias.double()[:, None, None], dx,
            (g64 * xhat).sum((0, 2, 3)), g64.sum((0, 2, 3)))


def near64(x, g, scale, bias):
    """The float64 results and twice the most that moving each plane's
    mean by ±δ moves them, δ = (⌈log2 H·W⌉ + 1)·2^-24·mean|x|: an f32 sum
    rounds at most ⌈log2 n⌉ times along a pairwise path, each by u = 2^-24
    of its partial sum, and the division once more (1.2e-3 at 700² planes
    of 1e3 ± 1, whose variance is 1/3)."""
    k = math.ceil(math.log2(x.shape[2] * x.shape[3])) + 1
    delta = k * 2.0 ** -24 * x.double().abs().mean((2, 3), keepdim=True)
    exact = norm64(x, g, scale, bias)
    moved = [norm64(x, g, scale, bias, sign * delta) for sign in (1.0, -1.0)]
    return exact, [2 * torch.maximum((p - e).abs(), (m - e).abs())
                   for e, p, m in zip(exact, *moved)]


def bf16_step(v):
    return (v.abs().clamp_min(2.0 ** -126).log2().floor() - 7).exp2()


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ANY_PLANES)
def test_instance_norm_kernel_any_plane(dev, dtype, shape, offset):
    """Forward and backward kernels at every plane size and base: the
    vector form where it applies, the cluster form for planes past one
    CTA's shared memory, the split form past a cluster's, else the warp
    form up to its cap and the general form past it, counted by form and
    dtype, within the encoders' bounds; dx is 0 on a 1-element plane.
    Values 1e3 ± 1 (± 64 in bf16) are held to float64 within ``near64``'s
    bound beside those, a bound that stays a small part of y and dx."""
    n, c, h, w, *loc = shape
    gen = torch.Generator().manual_seed(h * w + offset)
    spread = LOC_SPREAD_BF16 if dtype == torch.bfloat16 else 1.0
    values = (torch.randn(n, c, h, w, generator=gen) * 2 + 0.5 if not loc
              else loc[0] + (torch.rand(n, c, h, w, generator=gen) * 2 - 1)
              * spread)
    x = offset_view(values.to(dev, dtype), offset)
    g = offset_view(torch.randn(n, c, h, w, generator=gen).to(dev, dtype),
                    offset)
    scale = (1 + 0.3 * torch.randn(c, generator=gen)).to(dev)
    bias = (0.2 * torch.randn(c, generator=gen)).to(dev)
    assert x.is_contiguous() and x.storage_offset() == offset
    form = expected_form(h * w, offset)
    dt = "f32" if dtype == torch.float32 else "bf16"
    other = "bf16" if dtype == torch.float32 else "f32"

    def by_form():
        return [(fn.launches, *(fn.form_launches[f, d] for d in (dt, other)
                                for f in FORMS))
                for fn in (instance_norm_fwd, instance_norm_bwd)]

    before = by_form()
    y = instance_norm_fwd(x, scale, bias)
    got = instance_norm_bwd(x, g, scale)
    torch.cuda.synchronize()
    for now, was in zip(by_form(), before):
        assert [a - b for a, b in zip(now, was)] == [
            1, *(f == form for f in FORMS), *(0 for _ in FORMS)]
    if h * w == 1:
        assert (got[0] == 0).all()
    if loc:
        (y64, dx64, ds64, db64), (my, mdx, mds, _) = near64(x, g, scale, bias)
        assert my.max() < 0.05 * y64.abs().mean()
        assert mdx.max() < 0.05 * dx64.abs().mean()
        assert (mds < 0.05 * ds64.abs().max()).all()
        step = ((lambda v: 1e-5 * v.abs()) if dtype == torch.float32
                else bf16_step)
        assert ((y.double() - y64).abs() <= 1e-5 + step(y64) + my).all()
        dx, dscale, dbias = got
        assert ((dx.double() - dx64).abs() <= 1e-5 + step(dx64) + mdx).all()
        mag_s = (g.double() * norm64(x, g, scale, torch.zeros_like(bias))[0]
                 / scale.double()[:, None, None]).abs().sum((0, 2, 3))
        assert ((dscale.double() - ds64).abs() <= 1e-5 * mag_s + mds).all()
        assert ((dbias.double() - db64).abs()
                <= 1e-5 * g.double().abs().sum((0, 2, 3))).all()
        return
    want = instance_norm_reference(x, scale, bias).float()
    diff = (y.float() - want).abs()
    if dtype == torch.float32:
        assert (diff <= 1e-5 + 1e-5 * want.abs()).all(), diff.max()
    else:
        assert (diff <= 1e-5 + bf16_step(want)).all(), diff.max()
    assert_bwd_close(got, instance_norm_bwd_reference(x, g, scale), x, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_split_repeats_bit_for_bit(dev, dtype):
    """The split form (two launches forward, three backward, no float
    atomics): two forward and two backward calls give equal bits."""
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(2, 3, 700, 700, generator=gen) * 2 + 0.5).to(dev, dtype)
    g = torch.randn(2, 3, 700, 700, generator=gen).to(dev, dtype)
    scale = (1 + 0.3 * torch.randn(3, generator=gen)).to(dev)
    bias = (0.2 * torch.randn(3, generator=gen)).to(dev)
    dt = "f32" if dtype == torch.float32 else "bf16"
    f0 = instance_norm_fwd.form_launches["split", dt]
    b0 = instance_norm_bwd.form_launches["split", dt]
    ys = [instance_norm_fwd(x, scale, bias) for _ in range(2)]
    grads = [instance_norm_bwd(x, g, scale) for _ in range(2)]
    torch.cuda.synchronize()
    assert instance_norm_fwd.form_launches["split", dt] == f0 + 2
    assert instance_norm_bwd.form_launches["split", dt] == b0 + 2
    assert torch.equal(ys[0], ys[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# the cluster form's backward (redesigned: x and g staged in their own
# type, two cluster reductions of a pair): the plane just past one CTA
# (57,345 = 15 × 3823), the 240² and 256² stems, 240×320, the top of the
# form (458,752 = 448 × 1024), and 256² of values 1e3 ± 1 (± 64 in bf16)
CLUSTER_BWD_PLANES = [(1, 2, 15, 3823), (1, 3, 240, 240), (1, 2, 256, 256),
                      (1, 2, 240, 320), (1, 1, 448, 1024),
                      (1, 2, 256, 256, 1e3)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CLUSTER_BWD_PLANES)
def test_instance_norm_cluster_backward(dev, dtype, shape, offset):
    """The cluster form's backward at every plane size it takes and at an
    offset base: within the encoders' bounds of the plain version (values
    1e3 ± 1 within ``near64``'s bound of float64, which stays a small
    part of dx), counted as the cluster form, and two launches give equal
    bits (rank-ordered sums, no atomics)."""
    n, c, h, w, *loc = shape
    assert ONE_CTA_PLANE < h * w <= CLUSTER_PLANE
    gen = torch.Generator().manual_seed(h * w + offset)
    spread = LOC_SPREAD_BF16 if dtype == torch.bfloat16 else 1.0
    values = (torch.randn(n, c, h, w, generator=gen) * 2 + 0.5 if not loc
              else loc[0] + (torch.rand(n, c, h, w, generator=gen) * 2 - 1)
              * spread)
    x = offset_view(values.to(dev, dtype), offset)
    g = offset_view(torch.randn(n, c, h, w, generator=gen).to(dev, dtype),
                    offset)
    scale = (1 + 0.3 * torch.randn(c, generator=gen)).to(dev)
    dt = "f32" if dtype == torch.float32 else "bf16"
    before = instance_norm_bwd.form_launches["cluster", dt]
    got = instance_norm_bwd(x, g, scale)
    again = instance_norm_bwd(x, g, scale)
    torch.cuda.synchronize()
    assert instance_norm_bwd.form_launches["cluster", dt] == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if not loc:
        assert_bwd_close(got, instance_norm_bwd_reference(x, g, scale), x, g)
        return
    zero = torch.zeros_like(scale)
    (_, dx64, ds64, db64), (_, mdx, mds, _) = near64(x, g, scale, zero)
    assert mdx.max() < 0.05 * dx64.abs().mean()
    step = ((lambda v: 1e-5 * v.abs()) if dtype == torch.float32
            else bf16_step)
    dx, dscale, dbias = got
    assert ((dx.double() - dx64).abs() <= 1e-5 + step(dx64) + mdx).all()
    mag_s = (g.double() * norm64(x, g, torch.ones_like(scale), zero)[0]
             ).abs().sum((0, 2, 3))
    assert ((dscale.double() - ds64).abs() <= 1e-5 * mag_s + mds).all()
    assert ((dbias.double() - db64).abs()
            <= 1e-5 * g.double().abs().sum((0, 2, 3))).all()



# the general form (redesigned: 16-byte slots cut at each plane's own
# alignment, staged in shared memory in the plane's type, a one-launch
# backward): planes of 513 to 57,344 elements that the vector form does
# not take, at every storage offset (each head length of f32 and bf16),
# on each side of every limit inside the form: a warp a plane to a CTA a
# plane (f32 1,021 | 1,022, bf16 2,041 | 2,042); in the backward, g
# staged whole or in part (f32 14,333 | 14,334, bf16 28,665 | 28,666) and
# the whole SM's shared memory taken (f32 16,381 | 16,382, bf16 32,761 |
# 32,762, also where a CTA takes more than 8 slots a thread), g staged
# in part again (f32 28,925 | 28,926); in the forward, x staged in part
# (f32 28,669 | 28,670, bf16 57,337 | 57,338) and whole again in the
# whole SM's (f32 32,765 | 32,766); the top (57,343 and 57,344); the first
# general plane (513), 23², and ResNet-50's 175² planes at 1400² at that
# stage's width (128 channels)
GENERAL_PLANES = ([(2, 3, 1, hw) for hw in (
    513, 1021, 1022, 2041, 2042, 14333, 14334, 16381, 16382, 28665, 28666,
    28669, 28670, 28925, 28926, 32761, 32762, 32765, 32766, 57337, 57338,
    57343, 57344)]
                  + [(2, 3, 23, 23), (2, 128, 175, 175)])
# host seconds a trace stays idle after it starts and before it stops
# (chip_smoke's PROFILE_MARGIN_S: a margin for the drift between the
# host's and the trace's clocks)
TRACE_MARGIN_S = 0.05
# every (shape, offset, dtype) whose view the vector form does not take:
# an H·W that is not a multiple of 8, or a base off a 16-byte line
GENERAL_CASES = [(shape, offset, dtype) for shape in GENERAL_PLANES
                 for offset in range(8)
                 for dtype in (torch.float32, torch.bfloat16)
                 if (shape[2] * shape[3]) % 8
                 or offset * (4 if dtype == torch.float32 else 2) % 16]


@pytest.mark.parametrize("shape,offset,dtype", GENERAL_CASES)
def test_instance_norm_general_form(dev, shape, offset, dtype):
    """The general form's forward and backward within the encoders' bounds
    of the plain versions, counted as the general form; a backward is one
    launch (its kernel, and no reduce kernel, in a trace), and two calls
    of each give equal bits (no float atomics)."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from scflow_torch.utils.profiling import traced_kernels

    n, c, h, w = shape
    gen = torch.Generator().manual_seed(h * w + offset)
    x = offset_view((torch.randn(n, c, h, w, generator=gen) * 2 + 0.5).to(
        dev, dtype), offset)
    g = offset_view(torch.randn(n, c, h, w, generator=gen).to(dev, dtype),
                    offset)
    scale = (1 + 0.3 * torch.randn(c, generator=gen)).to(dev)
    bias = (0.2 * torch.randn(c, generator=gen)).to(dev)
    dt = "f32" if dtype == torch.float32 else "bf16"
    f0 = instance_norm_fwd.form_launches["general", dt]
    ys = [instance_norm_fwd(x, scale, bias) for _ in range(2)]
    torch.cuda.synchronize()
    assert instance_norm_fwd.form_launches["general", dt] == f0 + 2
    # a trace that lost a launch of the kernel itself is taken again (as
    # profiling.checked_trace does), up to three times, each idle for
    # chip_smoke's margin after it starts and before it stops
    for _ in range(3):
        b0 = instance_norm_bwd.form_launches["general", dt]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_MARGIN_S)
            grads = [instance_norm_bwd(x, g, scale) for _ in range(2)]
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
        assert instance_norm_bwd.form_launches["general", dt] == b0 + 2
        traced = traced_kernels(prof)
        if traced["instance_norm_bwd_any"] == 2:
            break
    assert traced == collections.Counter({"instance_norm_bwd_any": 2})
    assert torch.equal(ys[0], ys[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    want = instance_norm_reference(x, scale, bias).float()
    diff = (ys[0].float() - want).abs()
    if dtype == torch.float32:
        assert (diff <= 1e-5 + 1e-5 * want.abs()).all(), diff.max()
    else:
        assert (diff <= 1e-5 + bf16_step(want)).all(), diff.max()
    assert_bwd_close(grads[0], instance_norm_bwd_reference(x, g, scale), x, g)


def test_instance_norm_general_backward_streams(dev):
    """General-form backward launches on two streams at once draw tickets
    from counters of their own: every call gives the bits of a call alone
    on the default stream."""
    gen = torch.Generator().manual_seed(11)
    x = (torch.randn(8, 64, 23, 23, generator=gen) * 2 + 0.5).to(dev)
    g = torch.randn(8, 64, 23, 23, generator=gen).to(dev)
    scale = (1 + 0.3 * torch.randn(64, generator=gen)).to(dev)
    b0 = instance_norm_bwd.form_launches["general", "f32"]
    want = instance_norm_bwd(x, g, scale)
    streams = [torch.cuda.Stream() for _ in range(2)]
    got = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(4):
        for s in streams:
            with torch.cuda.stream(s):
                got.append(instance_norm_bwd(x, g, scale))
    torch.cuda.synchronize()
    assert instance_norm_bwd.form_launches["general", "f32"] == b0 + 9
    for grads in got:
        for a, b in zip(grads, want):
            assert torch.equal(a, b)

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


def small_faces_inputs(dev, n=4, faces=1024, size=256, seed=0, d_attr=0,
                       k_faces=rf.K_FACES, cluster=None, ties=False,
                       unusable=0.0, margins=False):
    """The tile pass's arguments for ``faces`` seeded triangles of 1-8
    pixels anywhere in a ``size``² frame (``cluster``: (x, y, radius) to
    heap them in one place, so that one tile overlaps more chunks than
    its k/8 slots), with random depths. ``ties``: the second half repeats
    the first's triangles and depths, so every covered pixel's z ties and
    the lower face id must win. ``unusable``: that share of faces marked
    invalid, inside boxes that stay. ``margins``: some boxes set to exactly
    a tile's ±0.5 pixel margin, NaN or ±inf (the selection's comparisons
    at their edges)."""
    gen = torch.Generator().manual_seed(seed)
    half = faces // 2 if ties else faces
    if cluster is None:
        centre = torch.rand(n, half, 1, 2, generator=gen) * size
    else:
        x, y, r = cluster
        centre = (torch.tensor([x, y]) + (torch.rand(n, half, 1, 2,
                                                     generator=gen) * 2 - 1)
                  * r)
    tri_xy = centre + (torch.rand(n, half, 3, 2, generator=gen) * 2 - 1) * 4
    tri_z = 500 + torch.rand(n, half, 1, generator=gen) * 200 + torch.rand(
        n, half, 3, generator=gen) * 5
    if ties:
        tri_xy, tri_z = torch.cat([tri_xy] * 2, 1), torch.cat([tri_z] * 2, 1)
    valid = torch.rand(n, faces, generator=gen) >= unusable
    attrs = (torch.rand(n, faces, 3, d_attr, generator=gen) if d_attr
             else None)
    coeff, bbox, attr, d, k = rf.tile_inputs(
        tri_xy.to(dev), tri_z.to(dev), valid.to(dev), size, size,
        None if attrs is None else attrs.to(dev), k_faces)
    if margins:
        bbox = bbox.clone()
        tile = torch.randint(0, size // rf.TILE, (n, faces, 2), generator=gen)
        edge = (tile * rf.TILE).float().to(dev)
        bbox[:, ::7, 1] = edge[:, ::7, 0] - 0.5          # xmax at the margin
        bbox[:, 1::7, 0] = edge[:, 1::7, 0] + rf.TILE - 0.5   # xmin
        bbox[:, 2::7, 3] = edge[:, 2::7, 1] - 0.5        # ymax
        bbox[:, 3::7, 2] = edge[:, 3::7, 1] + rf.TILE - 0.5   # ymin
        bbox[:, 4::97] = float("nan")
        bbox[:, 5::97, 0] = -float("inf")
        bbox[:, 5::97, 1] = float("inf")
    return coeff, bbox, attr, size, size, d, k


K1_SCENES = {
    # small faces across the 4-row blocks each warp owns
    "straddling": dict(),
    # one tile overlapping 128 chunks against 8 slots (k = 64): the first
    # 8 in face order must fill them
    "over_budget": dict(cluster=(100.0, 100.0, 12.0), k_faces=64),
    "z_ties": dict(ties=True, cluster=(128.0, 128.0, 40.0)),
    "unusable": dict(unusable=0.4, cluster=(64.0, 64.0, 50.0)),
    "margins": dict(margins=True),
}


@pytest.mark.parametrize("d_attr", [0, 9])
@pytest.mark.parametrize("scene", list(K1_SCENES))
def test_rasterize_kernel_small_faces(dev, scene, d_attr):
    """Seeded triangles a few pixels across, where the kernel's per-warp
    block culling and its binning launch decide the most: bit-equal to
    the plain version, without attributes and with Phong's 9."""
    args = small_faces_inputs(dev, d_attr=d_attr, **K1_SCENES[scene])
    got, want = rasterize_both(args)
    assert (want[0] >= 0).any()
    assert_bit_equal(got, want)
    if scene == "z_ties":    # the repeated half never wins a pixel
        assert (want[0] < args[0].shape[1] // 2).all()


@pytest.mark.parametrize("d_attr", [0, 9])
def test_rasterize_kernel_empty_frames(dev, d_attr):
    """Faces off the frame, or none usable: every tile empty, with and
    without attributes."""
    for shift, usable in ((2000.0, True), (0.0, False)):
        args = scene_inputs(dev, shift=shift, d_attr=d_attr)
        if not usable:
            coeff = args[0].clone()
            coeff[..., 14] = 0.0
            args = (coeff, *args[1:])
        got, want = rasterize_both(args)
        assert (want[0] == -1).all()
        assert_bit_equal(got, want)


@pytest.mark.parametrize("d_attr", [0, 9])
def test_rasterize_kernel_full_frames(dev, d_attr):
    """32 objects of the 21-class bank anywhere in 480×640 frames of
    YCB-V's camera, 700-1200 mm away (chip_smoke's frame renders): bit-
    equal, with and without attributes."""
    g = torch.Generator().manual_seed(5)
    from scflow_torch.geometry import quaternion_to_matrix

    n, (h, w) = 32, (480, 640)
    rot = quaternion_to_matrix(torch.randn(n, 4, generator=g))
    k = torch.tensor([[1066.778, 0.0, 312.9869], [0.0, 1067.487, 241.3109],
                      [0.0, 0.0, 1.0]]).expand(n, 3, 3)
    z = torch.rand(n, generator=g) * 500 + 700
    u = torch.rand(n, generator=g) * (w - 160) + 80
    v = torch.rand(n, generator=g) * (h - 160) + 80
    t = torch.stack([(u - k[:, 0, 2]) * z / k[:, 0, 0],
                     (v - k[:, 1, 2]) * z / k[:, 1, 1], z], dim=-1)
    labels = torch.randint(0, 21, (n,), generator=g)
    renderer = Renderer(make_test_meshes(21, subdivisions=3, radius=60.0,
                                         device=dev), image_size=(h, w))
    inp = renderer.rasterizer_inputs(rot.to(dev), t.to(dev),
                                     k.contiguous().to(dev), labels.to(dev))
    coeff, bbox, attr, d, kf = rf.tile_inputs(
        inp["tri_xy"], inp["tri_z"], inp["face_valid"], h, w,
        inp["tri_attrs"] if d_attr else None)
    got, want = rasterize_both((coeff, bbox, attr, h, w, d, kf))
    assert (want[0] >= 0).any() and (want[0] == -1).any()
    assert_bit_equal(got, want)


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


def test_pose_graph_tf32_bit_equal(dev):
    """The pose graph with TF32 on for matmuls and cuDNN gives the bits it
    gives with TF32 off (``chip_smoke.pose_graph_tf32``: both modes of
    ``solve_pose_graph`` on a seeded 6-object problem)."""
    import chip_smoke

    got = chip_smoke.pose_graph_tf32(None)
    assert got["bit_equal"] and all(got["bit_equal"].values()), got
