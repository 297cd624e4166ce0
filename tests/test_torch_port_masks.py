"""The port's ``InstanceMasks`` against the JAX package's: every method that
``tests/test_masks.py`` drives, on the same masks, gives equal masks,
areas, boxes and IoF. The JAX package warps with cv2 where it imports,
the port with ``cvops.warp_affine``, so rotations, shears and fractional
translations of seeded random masks show the two warps pixel for pixel."""
import numpy as np
import pytest

from port_common import one_torch_thread  # noqa: F401 (autouse)
from scflow_torch.data import InstanceMasks
from scflow_tpu.data.masks import InstanceMasks as JaxMasks


def square(h=16, w=16, y0=4, y1=8, x0=4, x1=8):
    m = np.zeros((h, w), bool)
    m[y0:y1, x0:x1] = True
    return m


def random_masks(n=3, h=48, w=64, seed=0):
    """Blobs: thresholded smooth noise, each with a different fill."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
        r = rng.uniform(0.15, 0.35) * min(h, w)
        wobble = 3 * np.sin(xs / rng.uniform(2, 6)) * np.cos(ys / 4.0)
        out.append((ys - cy) ** 2 + (xs - cx) ** 2 < (r + wobble) ** 2)
    return np.stack(out)


def same(port, jax_masks):
    assert type(port) is InstanceMasks
    assert (port.height, port.width) == (jax_masks.height, jax_masks.width)
    np.testing.assert_array_equal(port.masks, jax_masks.masks)


@pytest.fixture(params=["squares", "random"])
def both(request):
    if request.param == "squares":
        m = np.stack([square(), square(y0=0, y1=2, x0=0, x1=3),
                      square(y0=9, y1=15, x0=2, x1=13)])
    else:
        m = random_masks()
    return InstanceMasks(m), JaxMasks(m)


def test_queries(both):
    port, ref = both
    np.testing.assert_array_equal(port.areas, ref.areas)
    np.testing.assert_array_equal(port.get_bboxes(), ref.get_bboxes())
    np.testing.assert_array_equal(port.get_background_mask(),
                                  ref.get_background_mask())
    same(port.merge_background_mask(), ref.merge_background_mask())
    np.testing.assert_array_equal(port.cal_iof(port[:2]), ref.cal_iof(ref[:2]))
    same(port[1], ref[1])
    assert len(port) == len(ref)


def test_empty():
    port, ref = InstanceMasks(np.zeros((0, 8, 8), bool), 8, 8), JaxMasks(
        np.zeros((0, 8, 8), bool), 8, 8)
    same(port, ref)
    np.testing.assert_array_equal(port.get_background_mask(),
                                  ref.get_background_mask())
    same(port.resize((4, 6)), ref.resize((4, 6)))
    same(port.rotate(30.0), ref.rotate(30.0))


def test_resize_flip_pad_crop_expand(both):
    port, ref = both
    for out_hw in ((32, 32), (7, 9), (100, 30)):
        same(port.resize(out_hw), ref.resize(out_hw))
    for s in (0.5, 1.7):
        same(port.rescale(s), ref.rescale(s))
    for d in ("horizontal", "vertical", "diagonal"):
        same(port.flip(d), ref.flip(d))
    same(port.pad((20, 70)), ref.pad((20, 70)))
    same(port.pad((60, 80), pad_val=1), ref.pad((60, 80), pad_val=1))
    for box in ((4, 4, 8, 8), (-3, 2.6, 30.4, 12), (10, 10, 10, 10)):
        same(port.crop(box), ref.crop(box))
    same(port.expand(70, 90, 5, 11), ref.expand(70, 90, 5, 11))


def test_crop_and_resize(both):
    port, ref = both
    boxes = np.array([[0, 0, 8, 8], [8, 8, 16, 16], [-4, 3, 20, 40]])[:len(port)]
    for out_hw in ((4, 4), (13, 7)):
        same(port.crop_and_resize(boxes, out_hw),
             ref.crop_and_resize(boxes, out_hw))


def test_affine_warps(both):
    port, ref = both
    for off, d in ((4, "horizontal"), (-3, "vertical"), (2.5, "horizontal"),
                   (0.5, "vertical")):
        same(port.translate(off, d), ref.translate(off, d))
    same(port.translate(4, out_hw=(20, 30)), ref.translate(4, out_hw=(20, 30)))
    for mag, d in ((0.5, "horizontal"), (-0.3, "vertical")):
        same(port.shear(mag, d), ref.shear(mag, d))
    for angle, center, scale in ((180.0, None, 1.0), (33.0, None, 1.0),
                                 (-71.5, (10.0, 5.0), 1.3), (90.0, None, 0.7)):
        same(port.rotate(angle, center, scale), ref.rotate(angle, center, scale))
    m = np.array([[0.9, 0.2, 3.3], [-0.15, 1.1, -2.0]])
    same(port.warp_affine(m), ref.warp_affine(m))
    same(port.warp_affine(m, (40, 90)), ref.warp_affine(m, (40, 90)))
