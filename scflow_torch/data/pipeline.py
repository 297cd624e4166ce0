"""Host-side per-object pipeline (numpy): pose jitter, the reference
pose's bbox, the train crop and the fused eval crop → keep-ratio resize →
center pad → normalise (port of ``scflow_tpu/data/pipeline.py:22-181``
and of the JAX package's C++ crop).

Every 2D step is one 3×3 affine ``transform``; the camera intrinsics
absorb it (K' = T·K, the shipped configs' ``adapt_intrinsic`` mode), so
poses never change and no PnP runs on these paths. The other two modes
(``keep_intrinsic``, ``target_intrinsic``) re-solve the pose by a host
PnP instead (:func:`remap_pose`, :func:`apply_geometry_transform_mode`;
``scflow_tpu/data/pipeline.py:198-371``).

Two crops, one per builder, as the JAX package runs them:

- :func:`crop_resize_pad` (train) has the semantics of the JAX package's
  Python crop on cv2's bilinear resize (``cvops.resize_linear``, held to
  cv2), including its float pad offset ``int(out/2 - rh/2)``.
- :func:`crop_resize_pad_batch` (eval) has the semantics of
  ``CropResizePadNormalize`` in ``native/scflow_native.cpp`` (the path
  the JAX ``TestBatchBuilder`` takes where cv2 is absent). Its patch
  offset is the C++'s integer ``out/2 - rh/2``, so the two crops can
  place a patch one pixel apart when ``rh`` is odd, as in the reference.
  It runs in the host library's C++ (``csrc/crop.cpp``, one call per
  image); :func:`_crop_resize_pad_batch_np` is its numpy witness, which
  only tests and chip_smoke's checks call.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry.pnp import epnp
from ..training.config import JitterConfig
from ._build import library
from .cvops import resize_linear

# boxes of the eval crop: corners below 2^24 in magnitude, where float32
# holds every integer (and the C++ crop's arithmetic is the witness's)
_MAX_CORNER = float(1 << 24)


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
    box with no area gives a pad-only patch and the identity. One C++ call
    crops the boxes of each run of the same image object in ``images``.
    """
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    if len(boxes) != len(images):
        raise ValueError(f"{len(images)} images for {len(boxes)} boxes")
    if not (np.abs(boxes) < _MAX_CORNER).all():
        raise ValueError(f"crop boxes must be finite and within ±2^24: "
                         f"{boxes[~(np.abs(boxes) < _MAX_CORNER).all(1)]}")
    mean = np.ascontiguousarray(np.broadcast_to(np.float32(mean), 3))
    std = np.ascontiguousarray(np.broadcast_to(np.float32(std), 3))
    n = len(images)
    out = np.empty((n, out_size, out_size, 3), np.float32)
    transforms = np.empty((n, 3, 3), np.float32)
    lib, start = library(), 0
    while start < n:
        img = images[start]
        end = start + 1
        while end < n and images[end] is img:
            end += 1
        frame = np.ascontiguousarray(img)
        if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"crop: (H, W, 3) uint8 image expected, got "
                             f"{frame.shape} {frame.dtype}")
        lib.scflow_crop_resize_pad(
            frame.ctypes.data, frame.shape[0], frame.shape[1],
            boxes[start:].ctypes.data, end - start, out_size, pad_val,
            mean.ctypes.data, std.ctypes.data, out[start].ctypes.data,
            transforms[start].ctypes.data)
        start = end
    return out, transforms


def _crop_resize_pad_batch_np(images: list[np.ndarray], boxes: np.ndarray,
                              out_size: int, pad_val: float = 128.0,
                              mean=(0.0, 0.0, 0.0),
                              std=(255.0, 255.0, 255.0)):
    """:func:`crop_resize_pad_batch` in numpy: the witness of the C++."""
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


# ---------------------------------------------------------------------------
# Pose remapping under a 2D transform (reference RemapPose,
# datasets/pipelines/geometry_transform.py:22-150, and its test-time inverse
# models/utils/pose.py:264-309). Three geometry_transform modes:
# - 'adapt_intrinsic': fold the crop transform into K (K' = T @ K); the
#   pose is untouched.
# - 'keep_intrinsic': keep K; re-solve (R, t) so projection under K matches
#   the transformed 2D keypoints (EPnP + Levenberg-Marquardt).
# - 'target_intrinsic': re-solve (R, t) against a caller-supplied target K.
# ---------------------------------------------------------------------------

def _refine_pose_gn_np(r: np.ndarray, t: np.ndarray, pts: np.ndarray,
                       pix: np.ndarray, k: np.ndarray, iters: int = 20):
    """Float64 Levenberg-Marquardt on the reprojection error: a
    left-multiplied axis-angle delta on R, an additive one on t, JAX's step
    acceptance (up to 8 tries, λ ×0.3 on success, ×10 on failure) and its
    1e-12 stop."""
    fu, fv = k[0, 0], k[1, 1]

    def residual(r, t):
        cam = pts @ r.T + t
        zi = 1.0 / np.maximum(cam[:, 2], 1e-9)
        return np.concatenate([
            fu * cam[:, 0] * zi + k[0, 2] - pix[:, 0],
            fv * cam[:, 1] * zi + k[1, 2] - pix[:, 1]])

    lam = 1e-6
    cost = float(np.sum(residual(r, t) ** 2))
    for _ in range(iters):
        rp = pts @ r.T
        x, y, z = (rp + t).T
        zi = 1.0 / np.maximum(z, 1e-9)
        res = residual(r, t)
        du = np.stack([fu * zi, np.zeros_like(zi), -fu * x * zi * zi], -1)
        dv = np.stack([np.zeros_like(zi), fv * zi, -fv * y * zi * zi], -1)
        # d(R p)/dw = -[R p]x for R <- exp([w]x) R (t is added apart)
        px = np.zeros((len(pts), 3, 3))
        px[:, 0, 1], px[:, 0, 2] = -rp[:, 2], rp[:, 1]
        px[:, 1, 0], px[:, 1, 2] = rp[:, 2], -rp[:, 0]
        px[:, 2, 0], px[:, 2, 1] = -rp[:, 1], rp[:, 0]
        j_u = np.concatenate([-np.einsum("ni,nij->nj", du, px), du], -1)
        j_v = np.concatenate([-np.einsum("ni,nij->nj", dv, px), dv], -1)
        jac = np.concatenate([j_u, j_v], axis=0)
        jtj = jac.T @ jac
        jtr = jac.T @ res
        for _try in range(8):
            delta = -np.linalg.solve(jtj + lam * np.diag(np.diag(jtj))
                                     + 1e-12 * np.eye(6), jtr)
            w = delta[:3]
            angle = np.linalg.norm(w)
            if angle > 1e-14:
                ax = w / angle
                kx = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                               [-ax[1], ax[0], 0]])
                dr = (np.eye(3) + np.sin(angle) * kx
                      + (1 - np.cos(angle)) * kx @ kx)
            else:
                dr = np.eye(3)
            r_new, t_new = dr @ r, t + delta[3:]
            cost_new = float(np.sum(residual(r_new, t_new) ** 2))
            if cost_new <= cost:
                r, t, cost = r_new, t_new, cost_new
                lam = max(lam * 0.3, 1e-12)
                break
            lam *= 10.0
        if np.abs(delta).max() < 1e-12:
            break
    return r, t


def _solve_pnp_np(pts: np.ndarray, pix: np.ndarray, k: np.ndarray,
                  init_r: np.ndarray | None = None,
                  init_t: np.ndarray | None = None):
    """Host float64 PnP: JAX's branch without cv2. The initial pose is the
    port's EPnP in f32 on the CPU, its rotation projected onto SO(3) in
    float64 (the LM's left-multiplied updates keep any non-orthogonality
    of the start), then the float64 LM refines it."""
    if init_r is None:
        f32 = dict(dtype=torch.float32, device="cpu")
        init_r, init_t = epnp(torch.as_tensor(pts, **f32),
                              torch.as_tensor(pix, **f32),
                              torch.as_tensor(k, **f32))
        u, _, vt = np.linalg.svd(init_r.numpy().astype(np.float64))
        init_r = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
        init_t = init_t.numpy().astype(np.float64)
    return _refine_pose_gn_np(init_r, init_t, pts, pix,
                              np.asarray(k, np.float64))


def _project(pts: np.ndarray, r: np.ndarray, t: np.ndarray,
             k: np.ndarray) -> np.ndarray:
    cam = pts @ np.asarray(r, np.float64).T + np.asarray(t, np.float64)
    uv = cam[:, :2] / np.maximum(cam[:, 2:3], 1e-9)
    return uv * np.array([k[0, 0], k[1, 1]]) + np.array([k[0, 2], k[1, 2]])


def remap_pose(rotation: np.ndarray, translation: np.ndarray,
               keypoints_3d: np.ndarray, k_src: np.ndarray,
               transform: np.ndarray, k_dst: np.ndarray):
    """Re-solve a pose after a 2D affine ``transform`` of the image:
    project ``keypoints_3d`` under (``k_src``, pose), transform the pixels,
    solve PnP under ``k_dst``. Returns (rotation, translation) in float32
    and the re-solved pose's reprojection RMS error in pixels."""
    pts = np.asarray(keypoints_3d, np.float64)
    pix = _project(pts, rotation, translation, k_src)
    ones = np.ones((len(pix), 1))
    pix_t = (np.concatenate([pix, ones], axis=1) @ np.asarray(
        transform, np.float64).T)[:, :2]

    r_new, t_new = _solve_pnp_np(pts, pix_t, k_dst)
    r_new = r_new.astype(np.float32)
    t_new = t_new.astype(np.float32)
    pix2 = _project(pts, r_new, t_new, k_dst)
    rmsd = float(np.sqrt(np.mean(np.sum((pix2 - pix_t) ** 2, axis=1))))
    return r_new, t_new, rmsd


def remap_pose_to_origin_resolution(rotation: np.ndarray,
                                    translation: np.ndarray,
                                    keypoints_3d: np.ndarray,
                                    k_crop: np.ndarray,
                                    transform: np.ndarray,
                                    k_origin: np.ndarray,
                                    mode: str = "adapt_intrinsic"):
    """Map a pose predicted on the crop back to the original image;
    ``transform`` is the accumulated crop 3×3 and ``mode`` how the crop
    was made. Returns (rotation, translation, rmsd)."""
    if mode == "adapt_intrinsic":
        # K was adapted; the pose already lives in the original camera.
        return (np.asarray(rotation, np.float32),
                np.asarray(translation, np.float32), 0.0)
    if mode in ("keep_intrinsic", "target_intrinsic"):
        inv = np.linalg.inv(np.asarray(transform, np.float64))
        return remap_pose(rotation, translation, keypoints_3d, k_crop, inv,
                          k_origin)
    raise ValueError(f"unknown geometry transform mode {mode!r}")


def apply_geometry_transform_mode(crop: CropResult, rotation: np.ndarray,
                                  translation: np.ndarray,
                                  keypoints_3d: np.ndarray,
                                  k_src: np.ndarray, mode: str,
                                  target_k: np.ndarray | None = None):
    """(rotation, translation, k) for a crop's patch under one of the three
    modes."""
    if mode == "adapt_intrinsic":
        return (np.asarray(rotation, np.float32),
                np.asarray(translation, np.float32),
                crop.k_new.astype(np.float32))
    if mode == "keep_intrinsic":
        r, t, _ = remap_pose(rotation, translation, keypoints_3d, k_src,
                             crop.transform, k_src)
        return r, t, np.asarray(k_src, np.float32)
    if mode == "target_intrinsic":
        if target_k is None:
            raise ValueError("target_intrinsic needs target_k")
        r, t, _ = remap_pose(rotation, translation, keypoints_3d, k_src,
                             crop.transform, target_k)
        return r, t, np.asarray(target_k, np.float32)
    raise ValueError(f"unknown geometry transform mode {mode!r}")
