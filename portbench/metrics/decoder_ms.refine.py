"""Device ms a step of the decoder loop: correlation, GRU, heads, pose."""
from portbench.core import readers


def read(rec):
    return readers.layer_ms(rec, "refine", ("decoder",))
