"""torch.cuda.max_memory_allocated() over the window, after a reset at its
start, in GiB (None off the card)."""


def read(rec):
    return rec["peak_bytes"] / float(1 << 30) or None
