"""K1's least time from its work on the traced steps' own inputs ÷ its device time."""
from portbench.core import readers


def read(rec):
    return readers.roofline_pct(rec, "train", ("k1",), "k1_bound_s")
