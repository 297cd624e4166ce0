"""Host ms a step inside the port's ``step`` span (the span trace)."""
from portbench.core import spans


def read(rec):
    return spans.read(rec, "step_dispatch_ms", "train")
