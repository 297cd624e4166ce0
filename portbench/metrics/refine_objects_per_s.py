"""Objects refined over the whole window ÷ the window's seconds."""
from portbench.core import readers


def read(rec):
    return readers.window_rate(rec, "refine")
