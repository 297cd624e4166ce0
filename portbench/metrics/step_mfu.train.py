"""The reference's FLOPs of the window's steps ÷ its seconds on the host's clock ÷ the f32 peak."""
from portbench.core import readers


def read(rec):
    return readers.mfu_pct(rec, "train")
