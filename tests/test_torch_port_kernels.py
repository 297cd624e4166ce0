"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX. On a machine without JAX, leave out
``tests/conftest.py`` (it imports JAX):

    python -m pytest tests/test_torch_port_kernels.py --noconftest -q -p no:cacheprovider

Without an NVIDIA GPU every test here skips.
"""
import pytest
import torch

from scflow_torch.ops import rasterize_fast as rf
from scflow_torch.ops.fused_norm import (instance_norm, instance_norm_fwd,
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


def scene_inputs(dev, n=8, classes=5, subdivisions=3, size=256, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1)
    from scflow_torch.geometry import quaternion_to_matrix

    rot = quaternion_to_matrix(q)
    t = torch.cat([torch.rand(n, 2, generator=g) * 60 - 30,
                   torch.rand(n, 1, generator=g) * 400 + 500], dim=-1)
    k = torch.tensor([[500.0, 0, size / 2], [0, 500.0, size / 2], [0, 0, 1]])
    labels = torch.randint(0, classes, (n,), generator=g)
    renderer = Renderer(make_test_meshes(classes, subdivisions=subdivisions,
                                         radius=60.0, device=dev),
                        image_size=(size, size))
    inp = renderer.rasterizer_inputs(rot.to(dev), t.to(dev),
                                     k.expand(n, 3, 3).to(dev), labels.to(dev))
    return inp


@pytest.mark.parametrize("subdivisions,k_faces", [(3, 256), (1, 256), (3, 64)])
def test_rasterize_kernel(dev, subdivisions, k_faces):
    inp = scene_inputs(dev, subdivisions=subdivisions)
    coeff, sel, attr, d = rf.tile_inputs(
        inp["tri_xy"], inp["tri_z"], inp["face_valid"], 256, 256,
        inp["tri_attrs"], k_faces)
    before = rf.rasterize_tiles.launches
    key, zbuf, attrs = rf.rasterize_tiles(coeff, sel, attr, 256, 256, d)
    torch.cuda.synchronize()
    assert rf.rasterize_tiles.launches == before + 1
    key_r, zbuf_r, attrs_r = rf.rasterize_tiles_reference(coeff, sel, attr,
                                                          256, 256, d)
    # the same unfused f32 arithmetic in the same order: the keys agree
    # (test bound 0.2% of pixels), z and attributes where they do
    agree = (key == key_r)
    assert (~agree).float().mean().item() <= 0.002
    assert ((key_r < rf.BIG_KEY) & agree).any()
    torch.testing.assert_close(zbuf[agree], zbuf_r[agree], rtol=2e-4, atol=0)
    torch.testing.assert_close(attrs[agree], attrs_r[agree], rtol=0,
                               atol=2e-4 * attrs_r.abs().max().item())


def test_rasterize_kernel_refuses(dev):
    inp = scene_inputs(dev, n=1, subdivisions=1)
    coeff, sel, attr, d = rf.tile_inputs(
        inp["tri_xy"], inp["tri_z"], inp["face_valid"], 256, 256,
        inp["tri_attrs"])
    with pytest.raises(ValueError):
        rf.rasterize_tiles(coeff.double(), sel, attr, 256, 256, d)
    with pytest.raises(ValueError):
        rf.rasterize_tiles(coeff, sel.long(), attr, 256, 256, d)
    with pytest.raises(ValueError):
        rf.rasterize_tiles(coeff, sel, attr, 224, 256, d)
