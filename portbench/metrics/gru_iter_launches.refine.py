"""Device kernels, copies and sets launched inside one ``decoder.iter`` span (the span trace)."""
from portbench.core import spans


def read(rec):
    return spans.read(rec, "gru_iter_launches", "refine")
