"""Device ms a step of the losses, their targets, clip and AdamW."""
from portbench.core import readers


def read(rec):
    return readers.layer_ms(rec, "train", ("loss", "step"))
