"""Seconds from the process's start to the window: imports, inputs, build,
warm-up."""


def read(rec):
    return rec["setup_s"]
