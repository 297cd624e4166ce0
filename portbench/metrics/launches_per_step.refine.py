"""Device kernels, copies and sets a step in the plain trace."""
from portbench.core import readers


def read(rec):
    return readers.launches(rec, "refine")
