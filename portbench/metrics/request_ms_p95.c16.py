"""95th percentile of the latency of the window's requests, from the
``serve()`` call to its return, outside the traced stretch.  A per-layer
reading: the card is idle most of this cell's window, so the tail follows
the host's scheduling of 16 client threads and swings too widely to bound."""


def read(run, work):
    return work.get("request_ms_p95")
