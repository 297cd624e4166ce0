"""The port's numpy forms of OpenCV calls (``scflow_torch.data.cvops``)
against cv2 on seeded images, on the CPU: every one is bit-equal to
OpenCV's uint8 output (cv2 with its AVX2 kernels, as the JAX package calls
it here), over all inputs where the domain is small (the color
conversions) and over seeded sizes and transforms elsewhere."""
import cv2
import numpy as np
import pytest

from scflow_torch.data import cvops

RESIZES = [((480, 640), (256, 256)), ((100, 137), (256, 256)),
           ((173, 211), (256, 200)), ((300, 300), (64, 64)),
           ((97, 61), (64, 41)), ((512, 512), (256, 256)),
           ((50, 40), (256, 205)), ((64, 80), (64, 80)), ((3, 2), (64, 33))]


@pytest.mark.parametrize("src_hw,out_hw", RESIZES)
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_linear_matches_cv2(src_hw, out_hw, channels):
    """Down- and upscaling, an exact 2× reduction (cv2's area path), the
    identity, gray and RGB: bit-equal."""
    rng = np.random.default_rng(sum(src_hw) + channels)
    shape = src_hw if channels == 1 else (*src_hw, 3)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    want = cv2.resize(img, out_hw[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(cvops.resize_linear(img, out_hw), want)


def test_resize_linear_random_sizes():
    """200 seeded (source, output) sizes from 1 to 700 pixels a side."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        h, w = rng.integers(1, 700, 2)
        oh, ow = rng.integers(1, 300, 2)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.resize(img, (int(ow), int(oh)),
                          interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(cvops.resize_linear(img, (oh, ow)),
                                      want, err_msg=f"{(h, w, oh, ow)}")


def test_resize_mask_threshold_matches_cv2():
    """The train crop's mask: a 0/255 blob resized and thresholded above
    127."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[:211, :173]
    for _ in range(20):
        cy, cx, r = rng.uniform(0, 211), rng.uniform(0, 173), rng.uniform(5, 90)
        mask = (((yy - cy) ** 2 + (xx - cx) ** 2 < r * r) * 255).astype(np.uint8)
        out_hw = tuple(int(v) for v in rng.integers(8, 300, 2))
        want = cv2.resize(mask, out_hw[::-1],
                          interpolation=cv2.INTER_LINEAR) > 127
        np.testing.assert_array_equal(
            cvops.resize_linear(mask, out_hw) > 127, want)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("channels", [1, 3])
def test_gaussian_blur_matches_cv2(k, channels):
    rng = np.random.default_rng(k * 10 + channels)
    shape = (97, 131) if channels == 1 else (97, 131, 3)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(cvops.gaussian_blur(img, k),
                                  cv2.GaussianBlur(img, (k, k), 0))


def _all_colors(first: int) -> np.ndarray:
    """(256, 256, 3): every (first, second, third) uint8 triple."""
    g, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    return np.stack([np.full_like(g, first), g, b], -1).astype(np.uint8)


def test_rgb_to_gray_matches_cv2():
    """All 2^24 colors."""
    for r in range(256):
        img = _all_colors(r)
        np.testing.assert_array_equal(cvops.rgb_to_gray(img),
                                      cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


def test_rgb_to_hsv_matches_cv2():
    """All 2^24 colors, H in [0, 180]."""
    for r in range(256):
        img = _all_colors(r)
        np.testing.assert_array_equal(cvops.rgb_to_hsv(img),
                                      cv2.cvtColor(img, cv2.COLOR_RGB2HSV))


def test_hsv_to_rgb_matches_cv2():
    """Every HSV triple with H in [0, 180): bit-equal, so random_hsv's
    round trip is too."""
    for h in range(180):
        img = _all_colors(h)
        np.testing.assert_array_equal(cvops.hsv_to_rgb(img),
                                      cv2.cvtColor(img, cv2.COLOR_HSV2RGB))


def test_rotation_matrix_2d_matches_cv2():
    rng = np.random.default_rng(2)
    for _ in range(50):
        center = (float(rng.integers(0, 256)) + 0.5 * rng.integers(0, 2),
                  float(rng.uniform(0, 256)))
        angle, scale = rng.uniform(-45, 45), rng.uniform(0.2, 2.0)
        np.testing.assert_array_equal(
            cvops.rotation_matrix_2d(center, angle, scale),
            cv2.getRotationMatrix2D(center, angle, scale))


@pytest.mark.parametrize("nearest", [False, True])
def test_warp_affine_matches_cv2(nearest):
    """100 seeded rotations, scales and shifts of RGB and gray images into
    frames from 8 to 300 pixels wide (whole and partial vector steps),
    with taps outside the source: bit-equal."""
    rng = np.random.default_rng(3 + nearest)
    flags = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    for _ in range(100):
        w, h = (int(v) for v in rng.integers(8, 300, 2))
        m = cv2.getRotationMatrix2D(
            (float(rng.integers(0, w)) + 0.5 * rng.integers(0, 2),
             float(rng.integers(0, h)) + 0.5),
            rng.uniform(-45, 45), rng.uniform(0.3, 2.0))
        m[0, 2] += rng.uniform(-w / 2, w / 2)
        m[1, 2] += rng.uniform(-h / 2, h / 2)
        shape = (h, w, 3) if rng.integers(0, 2) else (h, w)
        img = (rng.integers(0, 2, shape[:2], dtype=np.uint8) if nearest
               else rng.integers(0, 256, shape, dtype=np.uint8))
        want = cv2.warpAffine(img, m, (w, h), flags=flags, borderValue=0)
        np.testing.assert_array_equal(
            cvops.warp_affine(img, m, (w, h), nearest=nearest), want)
