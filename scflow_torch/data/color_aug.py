"""Host-side color augmentations in numpy (port of
``scflow_tpu/data/color_aug.py``).

The reference's color transform stage (datasets/pipelines/
color_transform.py): HSV jitter, additive noise, Gaussian smoothing,
sharpness, grayscale, background replacement, and random occlusion
pasting, applied per uint8 image patch on the host data path. The cv2
calls of the JAX package are the port's ``cvops`` forms, and every
function draws from the ``Generator`` it is given in the JAX package's
order, so the same seed gives the same draws and the same pixels.
"""
from __future__ import annotations

import numpy as np

from .cvops import (gaussian_blur, hsv_jitter, resize_linear, rgb_to_gray,
                    rotation_matrix_2d, warp_affine)


def random_hsv(rng: np.random.Generator, img: np.ndarray, h_ratio=0.2,
               s_ratio=0.5, v_ratio=0.5) -> np.ndarray:
    """HSV jitter (reference RandomHSV, color_transform.py:77-101): the
    three draws here, the pixel pass fused in :func:`~.cvops.hsv_jitter`."""
    h = rng.uniform(-h_ratio, h_ratio) * 180
    s = 1.0 + rng.uniform(-s_ratio, s_ratio)
    v = 1.0 + rng.uniform(-v_ratio, v_ratio)
    return hsv_jitter(img, h, s, v)


def random_noise(rng: np.random.Generator, img: np.ndarray,
                 noise_ratio=0.1) -> np.ndarray:
    """Additive uniform noise (reference RandomNoise)."""
    noise = rng.uniform(-noise_ratio, noise_ratio, img.shape) * 255
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def random_smooth(rng: np.random.Generator, img: np.ndarray,
                  max_kernel_size=5) -> np.ndarray:
    """Gaussian blur with a random odd kernel (reference RandomSmooth)."""
    k = int(rng.integers(0, (max_kernel_size + 1) // 2)) * 2 + 1
    if k <= 1:
        return img
    return gaussian_blur(img, k)


def random_sharpness(rng: np.random.Generator, img: np.ndarray,
                     factor=0.5) -> np.ndarray:
    """Unsharp-mask style sharpening (reference RandomSharpness)."""
    blur = gaussian_blur(img, 3).astype(np.float32)
    alpha = rng.uniform(0, factor)
    out = img.astype(np.float32) * (1 + alpha) - blur * alpha
    return np.clip(out, 0, 255).astype(np.uint8)


def random_gray(rng: np.random.Generator, img: np.ndarray,
                p=0.1) -> np.ndarray:
    """Random grayscale conversion (reference RandomGray)."""
    if rng.uniform() > p:
        return img
    gray = rgb_to_gray(img)
    return np.stack([gray] * 3, axis=-1)


def random_background(rng: np.random.Generator, img: np.ndarray,
                      mask: np.ndarray, backgrounds: list[np.ndarray],
                      p=0.3) -> np.ndarray:
    """Replace the non-object region with a random background, resized
    to the image (reference RandomBackground, color_transform.py:176-244)."""
    if rng.uniform() > p or not backgrounds:
        return img
    bg = backgrounds[int(rng.integers(len(backgrounds)))]
    bg = resize_linear(bg, img.shape[:2])
    out = img.copy()
    out[~mask] = bg[~mask]
    return out


def random_occlusion(rng: np.random.Generator, img: np.ndarray,
                     mask: np.ndarray, p=0.3, size_range=(0.02, 0.7),
                     ratio_range=(0.5, 2.0)) -> tuple:
    """Noise-rectangle occluder (reference RandomOcclusion semantics,
    color_transform.py:273-327): rectangle area ~ U(size_range)·bbox_area
    with aspect ratio ~ U(ratio_range), centered uniformly inside the
    object's bbox, filled with uniform random noise; occluded pixels are
    removed from the visibility mask. Returns (image, updated mask)."""
    if rng.uniform() > p:
        return img, mask
    h, w = img.shape[:2]
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return img, mask
    bx1, bx2 = xs.min(), xs.max() + 1
    by1, by2 = ys.min(), ys.max() + 1
    area = rng.uniform(*size_range) * (bx2 - bx1) * (by2 - by1)
    ratio = rng.uniform(*ratio_range)
    ow = int(np.sqrt(area * ratio))
    oh = int(np.sqrt(area / ratio))
    if oh < 1 or ow < 1:
        return img, mask
    cx = rng.uniform(bx1, bx2)
    cy = rng.uniform(by1, by2)
    x1 = int(np.clip(cx - ow / 2 + 0.5, 0, w - 1))
    x2 = int(np.clip(cx + ow / 2 + 0.5, 0, w - 1))
    y1 = int(np.clip(cy - oh / 2 + 0.5, 0, h - 1))
    y2 = int(np.clip(cy + oh / 2 + 0.5, 0, h - 1))
    out = img.copy()
    out[y1:y2, x1:x2] = rng.integers(0, 256, (y2 - y1, x2 - x1, 3),
                                     dtype=np.uint8)
    new_mask = mask.copy()
    new_mask[y1:y2, x1:x2] = False
    return out, new_mask


def random_occlusion_v2(rng: np.random.Generator, img: np.ndarray,
                        mask: np.ndarray, occluder_img: np.ndarray,
                        occluder_mask: np.ndarray, p=1.0,
                        scale_range=(0.5, 1.0),
                        rotate_range=(-45, 45)) -> tuple:
    """Object-paste occluder (reference RandomOcclusionV2 behavior class,
    color_transform.py:329-403): warp another object's image patch —
    scaled so its visible area matches the target object's (jittered by
    ``scale_range``), rotated by ~U(rotate_range) degrees, translated so
    its center lands uniformly inside the target's bbox — then composite
    it over the image where the occluder is foreground and remove those
    pixels from the visibility mask. The train builder feeds crops of
    other objects from recent samples. Returns (image, updated mask).
    """
    if rng.uniform() > p:
        return img, mask
    h, w = img.shape[:2]
    oys, oxs = np.nonzero(occluder_mask)
    tys, txs = np.nonzero(mask)
    if len(oys) == 0 or len(tys) == 0:
        return img, mask
    ocx = (oxs.min() + oxs.max()) / 2.0
    ocy = (oys.min() + oys.max()) / 2.0
    # area-matched scale, jittered
    scale = float(np.sqrt(mask.sum() / max(occluder_mask.sum(), 1)))
    scale *= rng.uniform(*scale_range)
    angle = float(rng.uniform(*rotate_range))
    m = rotation_matrix_2d((float(ocx), float(ocy)), angle, scale)
    # translate the occluder center to a uniform point inside the bbox
    m[0, 2] += rng.uniform(txs.min(), txs.max() + 1) - ocx
    m[1, 2] += rng.uniform(tys.min(), tys.max() + 1) - ocy
    occ = warp_affine(occluder_img, m, (w, h))
    fg = warp_affine(occluder_mask.astype(np.uint8), m, (w, h),
                     nearest=True).astype(bool)
    out = img.copy()
    out[fg] = occ[fg]
    return out, (mask & ~fg)


def default_train_augs(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """The shipped SCFlow train recipe: HSV → noise → smooth
    (configs/refine_models/scflow_ycbv_pbr.py:69-71)."""
    img = random_hsv(rng, img)
    img = random_noise(rng, img)
    img = random_smooth(rng, img)
    return img
