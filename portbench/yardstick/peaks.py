"""Published dense peaks of each card the benchmark may run on, by
``torch.cuda.get_device_name()`` (NVIDIA H100 SXM data sheet: FP32 on the
CUDA cores 67 TFLOP/s, TF32 495, BF16 989 on the tensor cores; HBM3
3.35 TB/s). The figures assume the card's full power limit (700 W)."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "tf32": 495e12,
                              "bfloat16": 989e12, "bytes": 3.35e12},
}


def peaks(card: str) -> dict:
    """The peaks of ``card``; an unknown card raises, naming it."""
    if card not in PEAKS:
        raise ValueError(f"no peak figures for the card {card!r}")
    return PEAKS[card]
