"""Host-side per-object pipeline (numpy): pose jitter, the reference
pose's bbox, the train crop and the fused eval crop → keep-ratio resize →
center pad → normalise (port of ``scflow_tpu/data/pipeline.py:22-181``
and of the JAX package's C++ crop).

Every 2D step is one 3×3 affine ``transform``; the camera intrinsics
absorb it (K' = T·K, the shipped configs' ``adapt_intrinsic`` mode), so
poses never change and no PnP runs on these paths.

Two crops, one per builder, as the JAX package runs them:

- :func:`crop_resize_pad` (train) has the semantics of the JAX package's
  Python crop on cv2's bilinear resize (``cvops.resize_linear``, held to
  cv2), including its float pad offset ``int(out/2 - rh/2)``.
- :func:`crop_resize_pad_batch` (eval) has the semantics of
  ``CropResizePadNormalize`` in ``native/scflow_native.cpp`` (the path
  the JAX ``TestBatchBuilder`` takes where cv2 is absent). Its patch
  offset is the C++'s integer ``out/2 - rh/2``, so the two crops can
  place a patch one pixel apart when ``rh`` is odd, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..training.config import JitterConfig
from .cvops import resize_linear


def _euler_zyx_matrix(angles_deg):
    """Rotation from euler 'zyx' angles in degrees (scipy convention used by
    the reference jitter, datasets/pipelines/jitter.py:55)."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_euler("zyx", angles_deg, degrees=True).as_matrix()


def jitter_pose_np(rng: np.random.Generator, rotation: np.ndarray,
                   translation: np.ndarray, cfg: JitterConfig,
                   mesh_points: np.ndarray | None = None,
                   mesh_diameter: float | None = None,
                   max_tries: int = 50):
    """Rejection-sample SE(3) noise like the reference PoseJitter
    (jitter.py:51-79): per-axis Gaussian euler angles + Gaussian xyz offset,
    rejected until angle/translation/ADD limits hold; the JAX package's
    draws, in its order.

    Returns (ref_rotation, ref_translation, add_err, trans_err, rot_err).
    """
    for _ in range(max_tries):
        angles = rng.normal(0.0, cfg.angle_std_deg, size=3)
        delta_r = _euler_zyx_matrix(angles).astype(np.float32)
        ref_r = delta_r @ rotation
        cos = np.clip(0.5 * (np.trace(delta_r) - 1.0), -1.0, 1.0)
        rot_err = np.degrees(np.arccos(cos))
        if rot_err > cfg.angle_limit_deg:
            continue
        noise = rng.normal(0.0, [cfg.xy_std_mm, cfg.xy_std_mm, cfg.z_std_mm])
        trans_err = float(np.linalg.norm(noise))
        if trans_err > cfg.translation_limit_mm:
            continue
        ref_t = (translation + noise).astype(np.float32)
        add_err = np.nan
        if mesh_points is not None and mesh_diameter:
            gt_p = mesh_points @ rotation.T + translation
            ref_p = mesh_points @ ref_r.T + ref_t
            add_err = float(np.linalg.norm(gt_p - ref_p, axis=-1).mean()
                            / mesh_diameter)
            if cfg.add_limit is not None and add_err > cfg.add_limit:
                continue
        return ref_r, ref_t, add_err, trans_err, float(rot_err)
    return rotation.copy(), translation.copy(), 0.0, 0.0, 0.0


def project_bbox(points_3d: np.ndarray, k: np.ndarray, rotation: np.ndarray,
                 translation: np.ndarray, clip_shape=None) -> np.ndarray:
    """Project mesh points under a pose → xyxy bbox (reference ComputeBbox,
    datasets/pipelines/formatting.py:41-91)."""
    p = points_3d @ rotation.T + translation
    uvw = p @ k.T
    xy = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-8)
    bbox = np.array([xy[:, 0].min(), xy[:, 1].min(),
                     xy[:, 0].max(), xy[:, 1].max()], np.float32)
    if clip_shape is not None:
        h, w = clip_shape
        bbox = np.clip(bbox, [0, 0, 0, 0], [w, h, w, h])
    return bbox


@dataclasses.dataclass
class CropResult:
    patch: np.ndarray            # (S, S, 3) uint8
    transform: np.ndarray        # (3, 3) accumulated 2D affine
    k_new: np.ndarray            # (3, 3) adapted intrinsics
    scale_factor: float
    mask_patch: np.ndarray | None = None


def expand_bbox(bbox: np.ndarray, size_ratio: float = 1.0,
                aspect_ratio: float = 1.0) -> tuple[int, int, int, int]:
    """Square-ify + expand an xyxy bbox into integer crop corners — the
    box-shaping step of the reference Crop transform
    (geometry_transform.py:154-276)."""
    x1, y1, x2, y2 = bbox
    bw, bh = x2 - x1, y2 - y1
    xc, yc = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    bw = max(bw, bh * aspect_ratio)
    bh = max(bw / aspect_ratio, bh)
    bw, bh = bw * size_ratio, bh * size_ratio
    return (int(xc - bw / 2), int(yc - bh / 2),
            int(xc + bw / 2), int(yc + bh / 2))


def crop_resize_pad(image: np.ndarray, bbox: np.ndarray, k: np.ndarray,
                    out_size: int, size_ratio: float = 1.0,
                    aspect_ratio: float = 1.0, pad_val: int = 128,
                    mask: np.ndarray | None = None) -> CropResult:
    """Object-centric crop → keep-ratio resize → center pad, with the
    accumulated transform folded into the intrinsics (reference
    Crop/Resize/Pad stack, geometry_transform.py:154-501): the
    square-ified bbox expanded by ``size_ratio``, cropped with
    out-of-frame pixels at ``pad_val``, resized bilinearly so its longer
    side is ``out_size`` (cv2's resize), center-padded with ``pad_val``.
    A mask is resized as 0/255 and thresholded above 127."""
    h, w = image.shape[:2]
    cx1, cy1, cx2, cy2 = expand_bbox(bbox, size_ratio, aspect_ratio)

    t_crop = np.array([[1, 0, -cx1], [0, 1, -cy1], [0, 0, 1]], np.float32)

    # crop with out-of-frame padding
    ch, cw = cy2 - cy1, cx2 - cx1
    patch = np.full((ch, cw, 3), pad_val, image.dtype)
    sy1, sy2 = max(cy1, 0), min(cy2, h)
    sx1, sx2 = max(cx1, 0), min(cx2, w)
    if sy2 > sy1 and sx2 > sx1:
        patch[sy1 - cy1:sy2 - cy1, sx1 - cx1:sx2 - cx1] = image[sy1:sy2, sx1:sx2]
    mask_patch = None
    if mask is not None:
        mask_patch = np.zeros((ch, cw), mask.dtype)
        if sy2 > sy1 and sx2 > sx1:
            mask_patch[sy1 - cy1:sy2 - cy1, sx1 - cx1:sx2 - cx1] = mask[sy1:sy2, sx1:sx2]

    # keep-ratio resize: scale so max side == out_size
    scale = out_size / max(ch, cw)
    rh, rw = int(round(ch * scale)), int(round(cw * scale))
    patch = resize_linear(patch, (rh, rw))
    if mask_patch is not None:
        mask_patch = resize_linear(mask_patch.astype(np.uint8) * 255,
                                   (rh, rw)) > 127
    t_resize = np.array([[scale, 0, 0], [0, scale, 0], [0, 0, 1]], np.float32)

    # center pad to (out_size, out_size)
    top = int(out_size / 2 - rh / 2)
    left = int(out_size / 2 - rw / 2)
    out = np.full((out_size, out_size, 3), pad_val, patch.dtype)
    out[top:top + rh, left:left + rw] = patch
    if mask_patch is not None:
        mpad = np.zeros((out_size, out_size), bool)
        mpad[top:top + rh, left:left + rw] = mask_patch
        mask_patch = mpad
    t_pad = np.array([[1, 0, left], [0, 1, top], [0, 0, 1]], np.float32)

    transform = t_pad @ t_resize @ t_crop
    k_new = transform @ k  # adapt_intrinsic mode
    return CropResult(patch=out, transform=transform, k_new=k_new,
                      scale_factor=scale, mask_patch=mask_patch)


def normalize_image(img: np.ndarray, mean=(0., 0., 0.),
                    std=(255., 255., 255.)) -> np.ndarray:
    """uint8 RGB → float32 normalized (reference Normalize with the shipped
    mean/std giving [0, 1] images, configs/..._pbr.py:41-42,75)."""
    return ((img.astype(np.float32) - np.asarray(mean, np.float32))
            / np.asarray(std, np.float32))


def _padded_frame(img: np.ndarray, pad_val: np.float32) -> np.ndarray:
    """(H + 2, W + 2, 3) f32: the image inside a one-pixel ``pad_val``
    border, so a tap index clipped to [-1, H] (or [-1, W]) and shifted by
    one reads ``pad_val`` wherever the tap falls outside the frame."""
    h, w = img.shape[:2]
    out = np.full((h + 2, w + 2, img.shape[2]), pad_val, np.float32)
    out[1:-1, 1:-1] = img
    return out


def _crop_one(frame: np.ndarray, box, out_size: int, mean: np.ndarray,
              std: np.ndarray, out: np.ndarray, transform: np.ndarray) -> None:
    """One object from a :func:`_padded_frame`: fill ``out`` (S, S, 3) and
    ``transform`` (3, 3) in place, in the C++ crop's f32 arithmetic and
    order."""
    f32 = np.float32
    x1, y1, x2, y2 = (int(v) for v in box)      # C++ int(): toward zero
    ch, cw = y2 - y1, x2 - x1
    if ch <= 0 or cw <= 0:
        return                                  # pad only, identity transform
    scale = f32(out_size) / f32(max(ch, cw))
    rh, rw = (min(int(np.floor(float(f32(e) * scale) + 0.5)), out_size)
              for e in (ch, cw))                # lround
    top, left = out_size // 2 - rh // 2, out_size // 2 - rw // 2
    inv = f32(1.0) / scale
    h, w = frame.shape[0] - 2, frame.shape[1] - 2

    def taps(n, start, size):
        # (o + 0.5)·inv − 0.5 rounded once (the C++ build's fused
        # multiply-add; exact in float64), then + start in f32
        centre = (np.arange(n, dtype=f32) + f32(0.5)).astype(np.float64)
        s = (centre * np.float64(inv) - 0.5).astype(f32) + f32(start)
        i0 = np.floor(s).astype(np.int64)
        # indices into the padded frame of the taps i0 and i0 + 1
        return (np.clip(i0, -1, size) + 1, np.clip(i0 + 1, -1, size) + 1,
                s - i0.astype(f32))

    ya, yb, fy = taps(rh, y1, h)
    xa, xb, fx = taps(rw, x1, w)
    fy, fx = fy[:, None, None], fx[None, :, None]
    one = f32(1)
    top_row, bottom_row = frame[ya], frame[yb]   # (rh, W + 2, 3) each
    v = ((one - fy) * ((one - fx) * top_row[:, xa] + fx * top_row[:, xb])
         + fy * ((one - fx) * bottom_row[:, xa] + fx * bottom_row[:, xb]))
    out[top:top + rh, left:left + rw] = (v - mean) / std
    # -c·scale + offset rounded once, as the C++ build's fused multiply-add
    # (exact in float64: a 24-bit product plus a small integer)
    transform[0, 0] = transform[1, 1] = scale
    transform[0, 2] = -x1 * np.float64(scale) + left
    transform[1, 2] = -y1 * np.float64(scale) + top


def crop_resize_pad_batch(images: list[np.ndarray], boxes: np.ndarray,
                          out_size: int, pad_val: float = 128.0,
                          mean=(0.0, 0.0, 0.0), std=(255.0, 255.0, 255.0)):
    """Crop each (H, W, 3) uint8 image at its xyxy box (corners truncated
    to integers), resize keeping the ratio so the longer side is
    ``out_size`` (bilinear, half-pixel centres, taps outside the frame
    equal to ``pad_val``), center-pad with ``pad_val`` and normalise.

    Returns (patches (N, S, S, 3) f32, transforms (N, 3, 3) f32), where
    transform = pad ∘ resize ∘ crop maps image pixels to patch pixels. A
    box with no area gives a pad-only patch and the identity.
    """
    boxes = np.asarray(boxes, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    pad = np.float32(pad_val)
    n = len(images)
    out = np.empty((n, out_size, out_size, 3), np.float32)
    out[:] = (pad - mean) / std
    transforms = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    frames = {}                 # the objects of one image share its frame
    for i, img in enumerate(images):
        if id(img) not in frames:
            frames[id(img)] = _padded_frame(img, pad)
        _crop_one(frames[id(img)], boxes[i], out_size, mean, std, out[i],
                  transforms[i])
    return out, transforms
