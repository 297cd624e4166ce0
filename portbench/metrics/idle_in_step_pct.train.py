"""The share of the span trace's device idle time while the host was inside ``step``."""
from portbench.core import spans


def read(rec):
    return spans.read(rec, "idle_in_step_pct", "train")
