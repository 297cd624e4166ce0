"""Network modules of the PyTorch port against the JAX package, at full
channel widths on 64² inputs with 3 classes and the same (bridged) weights:
the feature (IN) and context (BN, eval) encoders, the correlation pyramid
and lookup, the GRU and every head, and the bilinear resizes. Inputs are
seeded numpy arrays; the port runs NCHW, the tests transpose."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_common import jax_refiner_variables, nchw, nhwc, port_refiner
from scflow_torch.models import corr as tcorr
from scflow_torch.models import layers as tlayers
from scflow_tpu.models import corr as jcorr
from scflow_tpu.models import layers as jlayers
from scflow_tpu.models.gru import ConvGRU
from scflow_tpu.models.heads import FlowMaskEmbed, MotionEncoder, PoseHead, XHead

FEAT = 8                      # feature map side at 64² inputs
# f32 convolutions summed in another order than XLA's: deep stacks get the
# JAX package's own encoder oracle bound, single heads 1e-5
ENCODER_TOL = dict(atol=2e-4, rtol=1e-4)
HEAD_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    jmodel, _, variables = jax_refiner_variables()
    tmodel, _ = port_refiner(variables)
    return jmodel, variables, tmodel


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("which", ["render_encoder", "context"])
def test_encoder(models, which):
    jmodel, variables, tmodel = models
    x = rand(2, 64, 64, 3)
    want = jmodel.apply(variables, jnp.asarray(x), False,
                        method=lambda m, img, train: getattr(m, which)(img, train))
    with torch.no_grad():
        got = getattr(tmodel, which)(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **ENCODER_TOL)


@pytest.mark.parametrize("hw", [FEAT, 32])     # 32: the 256² pyramid
def test_correlation_pyramid_and_lookup(hw):
    fr, fo = rand(2, hw, hw, 256, seed=1), rand(2, hw, hw, 256, seed=2)
    flow = rand(2, hw, hw, 2, seed=3, scale=3.0)
    want = jcorr.correlation_pyramid_pm(jnp.asarray(fr), jnp.asarray(fo), 4)
    got = tcorr.correlation_pyramid(nchw(fr), nchw(fo), 4)
    for w, g in zip(want, got):     # JAX (N, Hl, Wl, P), port (N, P, Hl, Wl)
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(w).transpose(0, 3, 1, 2),
                                   atol=1e-5, rtol=1e-5)
    want = jcorr.corr_lookup_pm(want, jnp.asarray(flow), radius=4)
    got = tcorr.corr_lookup(got, nchw(flow), radius=4)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def _iteration(variables, name):
    return {"params": variables["params"]["decoder"]["iteration"][name]}


def test_motion_encoder(models):
    _, variables, tmodel = models
    corr, flow = rand(2, FEAT, FEAT, 324, seed=4), rand(2, FEAT, FEAT, 2, seed=5)
    want = MotionEncoder().apply(_iteration(variables, "motion"),
                                 jnp.asarray(corr), jnp.asarray(flow))
    with torch.no_grad():
        got = tmodel.decoder.encoder(nchw(corr), nchw(flow))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **HEAD_TOL)


def test_conv_gru(models):
    _, variables, tmodel = models
    h, x = rand(2, FEAT, FEAT, 128, seed=6), rand(2, FEAT, FEAT, 256, seed=7)
    want = ConvGRU(128).apply(_iteration(variables, "gru"), jnp.asarray(h),
                              jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.decoder.gru(nchw(h), nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **HEAD_TOL)


@pytest.mark.parametrize("name,port,cin,head", [
    ("flow_head", "flow_pred", 128, lambda: XHead((256,), 2, "flow")),
    ("mask_head", "mask_pred", 128, lambda: XHead((256,), 1, "mask")),
    ("dflow_embed", "delta_flow_encoder", 2,
     lambda: FlowMaskEmbed((128, 64), (7, 3))),
    ("mask_embed", "mask_encoder", 1, lambda: FlowMaskEmbed((64, 32), (3, 3))),
])
def test_conv_heads(models, name, port, cin, head):
    _, variables, tmodel = models
    x = rand(2, FEAT, FEAT, cin, seed=8)
    want = head().apply(_iteration(variables, name), jnp.asarray(x))
    with torch.no_grad():
        got = getattr(tmodel.decoder, port)(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **HEAD_TOL)


def test_pose_head(models):
    _, variables, tmodel = models
    x = rand(3, FEAT, FEAT, 224, seed=9)
    label = np.array([2, 0, 1], np.int32)
    want = PoseHead(3, "ortho6d").apply(_iteration(variables, "pose_head"),
                                        jnp.asarray(x), jnp.asarray(label))
    with torch.no_grad():
        got = tmodel.decoder.pose_pred(nchw(x), torch.from_numpy(label).long())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **HEAD_TOL)


@pytest.mark.parametrize("src,dst", [((64, 64), (8, 8)), ((8, 8), (64, 64)),
                                     ((16, 12), (5, 7))])
def test_resize_bilinear_align_corners(src, dst):
    x = rand(2, *src, 3, seed=10, scale=50.0)
    want = jlayers.resize_bilinear_align_corners(jnp.asarray(x), dst)
    got = tlayers.resize_bilinear_align_corners(nchw(x), dst)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_flow_resampling():
    flow = rand(2, 64, 64, 2, seed=11, scale=5.0)
    small = jlayers.downsample_flow(jnp.asarray(flow), 8)
    np.testing.assert_allclose(
        nhwc(tlayers.downsample_flow(nchw(flow), 8)), np.asarray(small),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        nhwc(tlayers.upsample_flow(nchw(np.asarray(small)), 8)),
        np.asarray(jlayers.upsample_flow(small, 8)), atol=1e-5, rtol=1e-5)
