"""Binary instance-mask toolkit (host-side numpy; port of
``scflow_tpu/data/masks.py``).

The capability surface of the reference's ``BitmapMasks``
(datasets/mask.py:12-419): a stack of per-instance binary masks with
geometric transforms (rescale / resize / flip / pad / crop /
crop_and_resize / expand / translate / shear / rotate), area and bbox
queries, background-mask derivation, and intersection-over-foreground.
Masks are a dense (N, H, W) bool array. The affine warps are
``cvops.warp_affine`` nearest, bit-equal to ``cv2.warpAffine`` with
INTER_NEAREST, the branch the JAX package takes where cv2 imports.
"""
from __future__ import annotations

import numpy as np

from .cvops import warp_affine


def _resize_nearest(mask: np.ndarray, out_hw) -> np.ndarray:
    h, w = mask.shape[-2:]
    rh, rw = out_hw
    yi = np.clip((np.arange(rh) * h / max(rh, 1)).astype(int), 0, h - 1)
    xi = np.clip((np.arange(rw) * w / max(rw, 1)).astype(int), 0, w - 1)
    return mask[..., yi[:, None], xi[None, :]]


def _warp_affine_one(mask: np.ndarray, matrix: np.ndarray, out_hw) -> np.ndarray:
    """Nearest-neighbour affine warp of one bool mask (cv2's inverse map)."""
    warped = warp_affine(mask.astype(np.uint8), matrix[:2],
                         (out_hw[1], out_hw[0]), nearest=True)
    return warped > 0


class InstanceMasks:
    """A stack of per-instance binary masks of one image.

    Mirrors the reference ``BitmapMasks`` API surface; ``self.masks`` is
    (N, H, W) bool.
    """

    def __init__(self, masks, height: int | None = None,
                 width: int | None = None):
        masks = np.asarray(masks)
        if masks.size == 0 and masks.ndim != 3:
            assert height is not None and width is not None
            masks = np.zeros((0, height, width), bool)
        if masks.ndim == 2:
            masks = masks[None]
        self.masks = masks.astype(bool)
        self.height = self.masks.shape[1]
        self.width = self.masks.shape[2]

    def __len__(self) -> int:
        return len(self.masks)

    def __getitem__(self, idx) -> "InstanceMasks":
        sel = self.masks[idx]
        return InstanceMasks(sel.reshape(-1, self.height, self.width),
                             self.height, self.width)

    # ---- queries --------------------------------------------------------
    @property
    def areas(self) -> np.ndarray:
        """Per-instance pixel counts (mask.py:areas)."""
        return self.masks.sum(axis=(1, 2))

    def get_bboxes(self) -> np.ndarray:
        """Per-instance tight (x1, y1, x2, y2) boxes; empty mask → zeros
        (mask.py:get_bboxes)."""
        boxes = np.zeros((len(self), 4), np.float32)
        for i, m in enumerate(self.masks):
            ys, xs = np.nonzero(m)
            if len(xs):
                boxes[i] = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
        return boxes

    def get_background_mask(self) -> np.ndarray:
        """Pixels covered by no instance (mask.py:get_background_mask)."""
        return ~self.masks.any(axis=0)

    def merge_background_mask(self) -> "InstanceMasks":
        """Append the background mask as an extra instance
        (mask.py:merge_background_mask)."""
        bg = self.get_background_mask()[None]
        return InstanceMasks(np.concatenate([self.masks, bg], axis=0))

    def cal_iof(self, other: "InstanceMasks") -> np.ndarray:
        """Intersection-over-own-foreground vs each mask of ``other``:
        (N_self, N_other) (mask.py:cal_iof)."""
        a = self.masks.reshape(len(self), -1).astype(np.float32)
        b = other.masks.reshape(len(other), -1).astype(np.float32)
        inter = a @ b.T
        area = np.maximum(a.sum(-1, keepdims=True), 1.0)
        return inter / area

    # ---- geometric transforms ------------------------------------------
    def rescale(self, scale: float) -> "InstanceMasks":
        rh = max(int(round(self.height * scale)), 1)
        rw = max(int(round(self.width * scale)), 1)
        return self.resize((rh, rw))

    def resize(self, out_hw) -> "InstanceMasks":
        if len(self) == 0:
            return InstanceMasks(np.zeros((0,) + tuple(out_hw), bool))
        return InstanceMasks(_resize_nearest(self.masks, out_hw))

    def flip(self, direction: str = "horizontal") -> "InstanceMasks":
        if direction == "horizontal":
            return InstanceMasks(self.masks[:, :, ::-1])
        if direction == "vertical":
            return InstanceMasks(self.masks[:, ::-1])
        return InstanceMasks(self.masks[:, ::-1, ::-1])  # diagonal

    def pad(self, out_hw, pad_val: int = 0) -> "InstanceMasks":
        ph, pw = out_hw
        out = np.full((len(self), ph, pw), bool(pad_val))
        out[:, :self.height, :self.width] = \
            self.masks[:, :min(self.height, ph), :min(self.width, pw)]
        return InstanceMasks(out, ph, pw)

    def crop(self, bbox) -> "InstanceMasks":
        """Crop all masks by one (x1, y1, x2, y2) box (mask.py:crop)."""
        x1, y1, x2, y2 = (int(v) for v in np.round(bbox))
        x1, y1 = np.clip(x1, 0, self.width), np.clip(y1, 0, self.height)
        x2, y2 = np.clip(x2, x1 + 1, self.width), np.clip(y2, y1 + 1, self.height)
        return InstanceMasks(self.masks[:, y1:y2, x1:x2], y2 - y1, x2 - x1)

    def crop_and_resize(self, bboxes: np.ndarray, out_hw) -> "InstanceMasks":
        """Per-instance crop by its own box then resize (RoI-style,
        mask.py:crop_and_resize). Out-of-frame regions are zero."""
        out = np.zeros((len(self),) + tuple(out_hw), bool)
        for i, (m, box) in enumerate(zip(self.masks, bboxes)):
            x1, y1, x2, y2 = (int(v) for v in np.round(box))
            ch, cw = max(y2 - y1, 1), max(x2 - x1, 1)
            patch = np.zeros((ch, cw), bool)
            sy1, sy2 = max(y1, 0), min(y2, self.height)
            sx1, sx2 = max(x1, 0), min(x2, self.width)
            if sy2 > sy1 and sx2 > sx1:
                patch[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1] = m[sy1:sy2, sx1:sx2]
            out[i] = _resize_nearest(patch, out_hw)
        return InstanceMasks(out)

    def expand(self, expanded_h: int, expanded_w: int, top: int,
               left: int) -> "InstanceMasks":
        out = np.zeros((len(self), expanded_h, expanded_w), bool)
        out[:, top:top + self.height, left:left + self.width] = self.masks
        return InstanceMasks(out, expanded_h, expanded_w)

    def warp_affine(self, matrix: np.ndarray, out_hw=None) -> "InstanceMasks":
        out_hw = out_hw or (self.height, self.width)
        matrix = np.asarray(matrix, np.float64)
        out = np.stack([_warp_affine_one(m, matrix, out_hw)
                        for m in self.masks]) if len(self) else \
            np.zeros((0,) + tuple(out_hw), bool)
        return InstanceMasks(out, *out_hw)

    def translate(self, offset, direction: str = "horizontal",
                  out_hw=None) -> "InstanceMasks":
        dx, dy = (offset, 0) if direction == "horizontal" else (0, offset)
        return self.warp_affine(np.array([[1, 0, dx], [0, 1, dy]]), out_hw)

    def shear(self, magnitude: float, direction: str = "horizontal",
              out_hw=None) -> "InstanceMasks":
        if direction == "horizontal":
            m = np.array([[1, magnitude, 0], [0, 1, 0]])
        else:
            m = np.array([[1, 0, 0], [magnitude, 1, 0]])
        return self.warp_affine(m, out_hw)

    def rotate(self, angle_deg: float, center=None, scale: float = 1.0,
               out_hw=None) -> "InstanceMasks":
        cx, cy = center or (self.width / 2.0, self.height / 2.0)
        a = np.deg2rad(angle_deg)
        cos, sin = np.cos(a) * scale, np.sin(a) * scale
        m = np.array([[cos, sin, (1 - cos) * cx - sin * cy],
                      [-sin, cos, sin * cx + (1 - cos) * cy]])
        return self.warp_affine(m, out_hw)
