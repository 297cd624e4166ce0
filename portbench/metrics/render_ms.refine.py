"""Device ms a step of the render (the port's renderer, K1)."""
from portbench.core import readers


def read(rec):
    return readers.layer_ms(rec, "refine", ("render",))
