"""Host ms of one ``decoder.iter`` span, over iterations and steps (the span trace)."""
from portbench.core import spans


def read(rec):
    return spans.read(rec, "gru_iter_dispatch_ms", "refine")
