"""Instance norm of the PyTorch port (kernel K2's module) against the JAX
package's ``_reference_in`` (what ``FusedInstanceNorm`` runs there) and
``instance_norm``. On the CPU the port runs the plain version; the kernel
itself is held against it on the card in test_torch_port_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_torch.models.layers import FusedInstanceNorm
from scflow_torch.ops.fused_norm import (instance_norm, instance_norm_fwd,
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
    x, g, b = inputs(64)
    xt = to_nchw(x).requires_grad_()
    with pytest.raises(NotImplementedError, match="training slice"):
        instance_norm_fwd(xt, torch.from_numpy(g), torch.from_numpy(b))
    with pytest.raises(ValueError, match="CUDA"):
        instance_norm_fwd(xt.detach(), torch.from_numpy(g),
                          torch.from_numpy(b))

