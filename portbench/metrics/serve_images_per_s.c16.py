"""Images returned to the clients inside the traced run's window over its
seconds (the profiled stretch among them).  A per-layer reading: the card is
idle most of this cell's window, so the rate follows the host's pace of 16
client threads under one interpreter lock, and its runs spread too widely to
bound (PERF.md)."""


def read(run, work):
    return work.get("images_per_s")
