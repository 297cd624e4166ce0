"""K2's least time from the encoders' planes (forward and backward) ÷ its device time."""
from portbench.core import readers


def read(rec):
    return readers.roofline_pct(rec, "train", ("k2_fwd", "k2_bwd"), "k2_bound_s")
