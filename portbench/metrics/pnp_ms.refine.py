"""Device ms a step of RANSAC-EPnP on the last flow."""
from portbench.core import readers


def read(rec):
    return readers.layer_ms(rec, "refine", ("pnp",))
