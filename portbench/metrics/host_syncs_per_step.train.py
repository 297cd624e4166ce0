"""Blocking runtime calls a step inside the port's ``step`` span (the span trace)."""
from portbench.core import spans


def read(rec):
    return spans.read(rec, "host_syncs_per_step", "train")
