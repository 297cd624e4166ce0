"""The 90th percentile of the window's eval steps, dispatch to poses on the host."""
from portbench.core import readers


def read(rec):
    return readers.step_quantile_ms(rec, "refine", 90)
