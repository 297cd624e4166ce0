"""Instance norm of the PyTorch port (kernel K2's module) against the JAX
package's ``_reference_in`` (what ``FusedInstanceNorm`` runs there) and
``instance_norm``. On the CPU the port runs the plain version; the kernel
itself is held against it on the card in test_torch_port_kernels.py."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_torch.models.layers import FusedInstanceNorm
from scflow_torch.ops.fused_norm import (instance_norm, instance_norm_bwd,
                                         instance_norm_bwd_reference,
                                         instance_norm_fwd,
                                         instance_norm_reference)
from scflow_tpu.ops.fused_norm import _reference_in
from scflow_tpu.ops.fused_norm import instance_norm as jax_instance_norm

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def inputs(c, h=12, w=16, n=2, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, h, w, c)) * 2.0 + 0.5).astype(np.float32)
    g = (1.0 + 0.3 * rng.normal(size=c)).astype(np.float32)
    b = (0.2 * rng.normal(size=c)).astype(np.float32)
    return x, g, b


# planes beside the encoders' that the kernels' other forms serve (n, c,
# h, w, loc): the warp form's 1×1, 7², 13×17 and 14², the split form's
# 700²; values loc ± 1 = 1e3 ± 1 (loc 0: N(0.5, 2)) are the case that
# breaks E[x²] − μ² and that the split form's combination must survive
PLANES = {"1x1": (2, 3, 1, 1, 0.0), "7x7": (2, 16, 7, 7, 0.0),
          "13x17": (2, 5, 13, 17, 0.0), "14x14": (2, 8, 14, 14, 0.0),
          "700x700": (1, 1, 700, 700, 0.0), "1e3+-1": (1, 2, 700, 700, 1e3)}
# the spread of the loc plane's values by input type: bf16's step at 1e3
# is 4, so 1e3 ± 1 would round to a constant plane (a variance of 0, which
# checks nothing); 1e3 ± 64 keeps 33 distinct values
LOC_SPREAD = {"float32": 1.0, "bfloat16": 64.0}


def case_inputs(case, seed, spread=1.0):
    """``inputs`` at an encoder width (an int) or at a ``PLANES`` plane;
    a loc plane's values are loc ± ``spread``."""
    if case not in PLANES:
        return inputs(case, seed=seed)
    n, c, h, w, loc = PLANES[case]
    x, g, b = inputs(c, h, w, n, seed)
    if loc:
        x = (loc + spread * np.random.default_rng(seed).uniform(
            -1, 1, x.shape)).astype(np.float32)
    return x, g, b


def mean_rounding(x: np.ndarray) -> np.ndarray:
    """Bound on an f32 mean's error over axes (1, 2) of NHWC ``x``: a
    pairwise f32 sum of n terms rounds ⌈log2 n⌉ times along any path, each
    time by at most u = 2^-24 of the partial sum, so the sum is off by at
    most ⌈log2 n⌉·u·Σ|x|; the division rounds once more. (⌈log2 n⌉ + 1)·u
    ·mean|x| per (sample, channel): 20 u·1e3 = 1.2e-3 at 700² planes of
    1e3 ± 1, where the variance is 1/3."""
    n = x.shape[1] * x.shape[2]
    k = math.ceil(math.log2(n)) + 1
    return k * 2.0 ** -24 * np.abs(x.astype(np.float64)).mean(
        (1, 2), keepdims=True)


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values (8 significand bits) at magnitude |v|."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def norm64(x, gy, s, b, shift=0.0, eps=1e-5):
    """The forward and ``_bwd``'s backward in float64 on NHWC inputs, with
    each plane's mean moved by ``shift``: y, dx, dscale, dbias."""
    x64, g64 = x.astype(np.float64), gy.astype(np.float64)
    mu = x64.mean((1, 2), keepdims=True) + shift
    inv = 1.0 / np.sqrt(((x64 - mu) ** 2).mean((1, 2), keepdims=True) + eps)
    xhat = (x64 - mu) * inv
    gs = g64 * s
    dx = inv * (gs - gs.mean((1, 2), keepdims=True)
                - xhat * (gs * xhat).mean((1, 2), keepdims=True))
    return (xhat * s + b, dx, (g64 * xhat).sum((0, 1, 2)),
            g64.sum((0, 1, 2)))


def near64(x, gy, s, b):
    """The float64 results and, per result, twice the most that moving each
    plane's mean by ±``mean_rounding`` moves them: what an f32 mean can
    cost at that magnitude (the factor 2 covers what lies between)."""
    exact = norm64(x, gy, s, b)
    delta = mean_rounding(x)
    moved = [norm64(x, gy, s, b, sign * delta) for sign in (1.0, -1.0)]
    return exact, [2 * np.maximum(np.abs(p - e), np.abs(m - e))
                   for e, p, m in zip(exact, *moved)]


# the encoder widths (12×16 planes), then PLANES
@pytest.mark.parametrize("c", [64, 96, 128, *PLANES])
def test_plain_path_matches_jax(c):
    """f32 statistics on both sides, sums in different orders: 1e-5. At
    1e3 ± 1 an f32 mean is off by up to ``mean_rounding`` (JAX's CPU sum
    by ~11 ulps of 1e3), which y carries times inv·|scale| against 1e-5:
    both sides are held to the float64 forward within that."""
    x, g, b = case_inputs(c, 0)
    got = instance_norm(to_nchw(x), torch.from_numpy(g), torch.from_numpy(b))
    got = got.numpy().transpose(0, 2, 3, 1)
    wants = [np.asarray(f(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                          1e-5)) for f in (_reference_in, jax_instance_norm)]
    if c in PLANES and PLANES[c][4]:
        (y64, *_), (moved, *_) = near64(x, np.zeros_like(x), g, b)
        # the bound stays a small part of the output, so it holds y
        assert moved.max() < 0.05 * np.abs(y64).mean()
        allow = 1e-5 + 1e-5 * np.abs(y64) + moved
        for y in (got, *wants):
            assert (np.abs(y - y64) <= allow).all(), np.abs(y - y64).max()
        return
    for want in wants:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bf16_keeps_dtype_within_one_ulp():
    x, g, b = inputs(64, seed=1)
    xb = to_nchw(x).to(torch.bfloat16)
    got = instance_norm(xb, torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    f32 = instance_norm(xb.float(), torch.from_numpy(g),
                        torch.from_numpy(b)).to(torch.bfloat16)
    want = np.asarray(_reference_in(
        jnp.asarray(xb.float().numpy().transpose(0, 2, 3, 1), jnp.bfloat16),
        jnp.asarray(g), jnp.asarray(b), 1e-5), np.float32).transpose(0, 3, 1, 2)
    got = got.float().numpy()
    for ref in (f32.float().numpy(), want):
        assert (np.abs(got - ref) <= bf16_ulp(ref)).all()


def test_module_applies_its_affine():
    x, g, b = inputs(96, seed=2)
    norm = FusedInstanceNorm(96)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(g))
        norm.bias.copy_(torch.from_numpy(b))
        got = norm(to_nchw(x))
    want = instance_norm_reference(to_nchw(x), torch.from_numpy(g),
                                   torch.from_numpy(b))
    assert torch.equal(got, want)


def test_kernel_wrapper_refuses_grad_and_cpu():
    # the raw wrapper records no graph; gradients go through instance_norm
    x, g, b = inputs(64)
    xt = to_nchw(x).requires_grad_()
    with pytest.raises(RuntimeError, match="call instance_norm"):
        instance_norm_fwd(xt, torch.from_numpy(g), torch.from_numpy(b))
    with pytest.raises(ValueError, match="CUDA"):
        instance_norm_fwd(xt.detach(), torch.from_numpy(g),
                          torch.from_numpy(b))
    with pytest.raises(ValueError, match="CUDA"):
        instance_norm_bwd(xt.detach(), xt.detach(), torch.from_numpy(g))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [64, 96, 128, *PLANES])
def test_bwd_reference_matches_jax_vjp(c, dtype):
    """The plain backward against ``jax.vjp`` of the JAX package's
    ``instance_norm`` (its ``_bwd`` under ``custom_vjp``). f32: 1e-5 (sums
    in another order). bf16: both round the f32 result once, so one bf16
    step plus that spread for dx; dscale/dbias are f32 sums of bf16-rounded
    terms, 1e-5 of the sum of their magnitudes. At 1e3 ± 1 (1e3 ± 64 in
    bf16: ``LOC_SPREAD``) both sides against the float64 backward on the
    same (rounded) inputs, beside those bounds within ``near64``'s, which
    stays a small part of dx."""
    import jax

    x, s, b = case_inputs(c, 3, LOC_SPREAD[dtype])
    channels = x.shape[-1]
    gy = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(gy, jdt)
    _, vjp = jax.vjp(lambda a, sc, bi: jax_instance_norm(a, sc, bi, 1e-5),
                     xj, jnp.asarray(s), jnp.asarray(b))
    want = [np.asarray(v, np.float32) for v in vjp(gj)]
    tdt = getattr(torch, dtype)
    xt = to_nchw(np.asarray(xj, np.float32)).to(tdt)
    gt = to_nchw(np.asarray(gj, np.float32)).to(tdt)
    dx, dscale, dbias = instance_norm_bwd_reference(xt, gt, torch.from_numpy(s))
    assert dx.dtype == tdt and dscale.dtype == torch.float32
    dx = dx.float().numpy().transpose(0, 2, 3, 1)
    gf = gt.float()
    mag = {"scale": (gf * instance_norm_reference(
        xt.float(), torch.ones(channels), torch.zeros(channels))
                     ).abs().sum((0, 2, 3)).numpy(),
           "bias": gf.abs().sum((0, 2, 3)).numpy()}
    if c in PLANES and PLANES[c][4]:
        xr, gr = (np.asarray(v, np.float32) for v in (xj, gj))
        (_, dx64, ds64, db64), (_, mdx, mds, _) = near64(xr, gr, s, b)
        assert mdx.max() < 0.05 * np.abs(dx64).mean()
        assert (mds < 0.05 * np.abs(ds64).max()).all()
        step = 1e-5 * np.abs(dx64) if dtype == "float32" else bf16_ulp(dx64)
        for got_dx, got_s, got_b in ((dx, dscale.numpy(), dbias.numpy()),
                                     want):
            assert (np.abs(got_dx - dx64) <= 1e-5 + step + mdx).all()
            assert (np.abs(got_s - ds64) <= 1e-5 * mag["scale"] + mds).all()
            assert (np.abs(got_b - db64) <= 1e-5 * mag["bias"]).all()
        return
    if dtype == "float32":
        np.testing.assert_allclose(dx, want[0], atol=1e-5, rtol=1e-5)
    else:
        assert (np.abs(dx - want[0]) <= 1e-5 + bf16_ulp(want[0])).all()
    for got, ref, key in ((dscale, want[1], "scale"), (dbias, want[2], "bias")):
        assert (np.abs(got.numpy() - ref) <= 1e-5 * mag[key]).all()


def test_function_gradcheck_float64():
    x, g, b = inputs(5, h=4, w=6, seed=5)
    args = (to_nchw(x).double().requires_grad_(),
            torch.from_numpy(g).double().requires_grad_(),
            torch.from_numpy(b).double().requires_grad_())
    assert torch.autograd.gradcheck(
        lambda *a: instance_norm(*a, 1e-5), args, eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_train_mode_batch_norm_matches_flax(masked):
    """Train-mode BN against flax ``nn.BatchNorm(momentum=0.9)`` as the JAX
    ``ConvBlock`` runs it: output, the input/scale/bias gradients for a
    seeded output gradient, and the updated running statistics (biased
    variance). f32 sums in another order: 1e-5; the gradients 1e-5 of their
    largest element as well."""
    import jax
    from flax import linen as fnn

    from scflow_torch.models.layers import BatchNorm

    x, s, b = inputs(16, h=6, w=8, n=4, seed=6)
    gy = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32) if masked else None
    rng = np.random.default_rng(8)
    mean0 = (0.1 * rng.normal(size=16)).astype(np.float32)
    var0 = (1.0 + 0.2 * np.abs(rng.normal(size=16))).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, epsilon=1e-5, momentum=0.9)
    fmask = None
    if masked:
        fmask = jnp.broadcast_to(jnp.asarray(mask > 0.5)[:, None, None, None],
                                 x.shape)

    def apply(xj, sj, bj):
        return bn.apply({"params": {"scale": sj, "bias": bj},
                         "batch_stats": {"mean": jnp.asarray(mean0),
                                         "var": jnp.asarray(var0)}},
                        xj, mask=fmask, mutable=["batch_stats"])

    want, stats = apply(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    _, vjp = jax.vjp(lambda *a: apply(*a)[0], jnp.asarray(x), jnp.asarray(s),
                     jnp.asarray(b))
    want_grads = [np.asarray(v) for v in vjp(jnp.asarray(gy))]

    norm = BatchNorm(16, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(s))
        norm.bias.copy_(torch.from_numpy(b))
        norm.running_mean.copy_(torch.from_numpy(mean0))
        norm.running_var.copy_(torch.from_numpy(var0))
    xt = to_nchw(x).requires_grad_()
    got = norm(xt, None if mask is None else torch.from_numpy(mask))
    got.backward(to_nchw(gy))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    for g, w in zip((xt.grad.numpy().transpose(0, 2, 3, 1),
                     norm.weight.grad.numpy(), norm.bias.grad.numpy()),
                    want_grads):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    for buf, key in ((norm.running_mean, "mean"), (norm.running_var, "var")):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(stats["batch_stats"][key]),
                                   atol=1e-6, rtol=1e-6)
    # eval mode: nn.BatchNorm2d on the running statistics, as before
    norm.eval()
    with torch.no_grad():
        ev = norm(to_nchw(x))
    want_ev = ((to_nchw(x) - norm.running_mean[:, None, None])
               / torch.sqrt(norm.running_var[:, None, None] + 1e-5)
               * norm.weight[:, None, None] + norm.bias[:, None, None])
    torch.testing.assert_close(ev, want_ev.detach(), atol=1e-5, rtol=1e-5)
