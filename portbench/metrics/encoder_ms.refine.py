"""Device ms a step of the feature and context encoders (K2 among them)."""
from portbench.core import readers


def read(rec):
    return readers.layer_ms(rec, "refine", ("encoder",))
