"""K2's least time from the encoders' planes (forward) ÷ its device time."""
from portbench.core import readers


def read(rec):
    return readers.roofline_pct(rec, "refine", ("k2_fwd",), "k2_bound_s")
