"""Requests the coalescer folds into one dispatch over the window: the
change of ``WarmGenerator.stats`` served over its change in dispatches."""


def read(run, work):
    return work.get("requests_per_dispatch")
