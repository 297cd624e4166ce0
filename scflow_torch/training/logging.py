"""Training observability: image panels and per-iteration EPE (port of
``scflow_tpu/training/logging.py``).

Panels are assembled on the host (flow → RGB with the invalid-sentinel
convention) and written as PNGs under ``work_dir/images`` with the port's
own encoder (``utils.tb_writer.encode_png``: stdlib zlib, no cv2 or PIL),
and mirrored into a TensorBoard event file.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry.flow import endpoint_error
from ..utils.flow_vis import flow_to_rgb
from ..utils.tb_writer import TBEventWriter, encode_png


def _to_u8(img: np.ndarray) -> np.ndarray:
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def make_train_panel(real_image, rendered_image, gt_flow, pose_flow,
                     pred_flow, mask=None, max_flow: float = 400.0):
    """Horizontal panel [real | render | gt flow | pose flow | pred flow
    (| mask)] for one sample; all inputs HWC numpy, flows (H, W, 2)."""
    cols = [
        _to_u8(np.asarray(real_image)),
        _to_u8(np.asarray(rendered_image)),
        _to_u8(flow_to_rgb(np.asarray(gt_flow), unknown_thr=max_flow - 1)),
        _to_u8(flow_to_rgb(np.asarray(pose_flow), unknown_thr=max_flow - 1)),
        _to_u8(flow_to_rgb(np.asarray(pred_flow), unknown_thr=max_flow - 1)),
    ]
    if mask is not None:
        m = np.asarray(mask)
        cols.append(_to_u8(np.repeat(m[..., None], 3, axis=-1)))
    return np.concatenate(cols, axis=1)


class ImageLogger:
    """Periodic image-panel logger (PNG + TensorBoard event file)."""

    def __init__(self, work_dir: str, tensorboard: bool = True):
        self.image_dir = os.path.join(work_dir, "images")
        self._tb = None
        if tensorboard:
            self._tb = TBEventWriter(os.path.join(work_dir, "tb"),
                                     filename_suffix=".images")

    def log_panel(self, step: int, name: str, panel: np.ndarray):
        os.makedirs(self.image_dir, exist_ok=True)
        path = os.path.join(self.image_dir, f"{name}_{step:08d}.png")
        with open(path, "wb") as f:
            f.write(encode_png(panel))
        if self._tb is not None:
            self._tb.add_image(name, panel, step)
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()


def sequence_epe_report(seq_flow: torch.Tensor, gt_flow: torch.Tensor,
                        valid: torch.Tensor | None = None,
                        max_flow: float = 400.0) -> list[dict]:
    """Per-iteration EPE / accuracy report for a (T, N, H, W, 2) flow
    sequence (the reference's eval_seq_epe debug eval,
    base_refiner.py:464-480, without the disk dumps): a list of T dicts
    of floats with keys epe/acc1/acc3/acc5."""
    mag_ok = torch.linalg.vector_norm(gt_flow, dim=-1) < max_flow
    v = mag_ok if valid is None else (mag_ok & (valid >= 0.5))
    return [{k: float(x) for k, x in endpoint_error(f, gt_flow, v).items()}
            for f in seq_flow]
