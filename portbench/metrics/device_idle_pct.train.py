"""1 − the union of kernel intervals ÷ the plain trace's wall time."""
from portbench.core import readers


def read(rec):
    return readers.idle_pct(rec, "train")
