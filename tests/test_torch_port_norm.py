"""Instance norm of the PyTorch port (kernel K2's module) against the JAX
package's ``_reference_in`` (what ``FusedInstanceNorm`` runs there) and
``instance_norm``. On the CPU the port runs the plain version; the kernel
itself is held against it on the card in test_torch_port_kernels.py."""
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


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values (8 significand bits) at magnitude |v|."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("c", [64, 96, 128])      # the encoder widths
def test_plain_path_matches_jax(c):
    # f32 statistics on both sides, sums in different orders: 1e-5
    x, g, b = inputs(c)
    got = instance_norm(to_nchw(x), torch.from_numpy(g), torch.from_numpy(b))
    got = got.numpy().transpose(0, 2, 3, 1)
    for want in (_reference_in(jnp.asarray(x), jnp.asarray(g),
                               jnp.asarray(b), 1e-5),
                 jax_instance_norm(jnp.asarray(x), jnp.asarray(g),
                                   jnp.asarray(b), 1e-5)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


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
@pytest.mark.parametrize("c", [64, 96, 128])
def test_bwd_reference_matches_jax_vjp(c, dtype):
    """The plain backward against ``jax.vjp`` of the JAX package's
    ``instance_norm`` (its ``_bwd`` under ``custom_vjp``). f32: 1e-5 (sums
    in another order). bf16: both round the f32 result once, so one bf16
    step plus that spread for dx; dscale/dbias are f32 sums of bf16-rounded
    terms, 1e-5 of the sum of their magnitudes."""
    import jax

    x, s, b = inputs(c, seed=3)
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
    if dtype == "float32":
        np.testing.assert_allclose(dx, want[0], atol=1e-5, rtol=1e-5)
    else:
        assert (np.abs(dx - want[0]) <= 1e-5 + bf16_ulp(want[0])).all()
    gf = gt.float()
    mag = {"scale": (gf * instance_norm_reference(
        xt.float(), torch.ones(c), torch.zeros(c))).abs().sum((0, 2, 3)),
        "bias": gf.abs().sum((0, 2, 3))}
    for got, ref, key in ((dscale, want[1], "scale"), (dbias, want[2], "bias")):
        assert (np.abs(got.numpy() - ref) <= 1e-5 * mag[key].numpy()).all()


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
