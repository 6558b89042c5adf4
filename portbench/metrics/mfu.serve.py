"""Model FLOP utilisation of serving: the least time of the traced
dispatches' images (sweeps and decode) at the H100's peaks, over the stretch."""

from yardstick.work import served_image_least_s


def read(run, work):
    if not work.get("trace") or not work.get("dispatches"):
        return None
    cfg = work["config"]
    images = sum(work["dispatches"]) * cfg["NUM_READS"]
    return 100.0 * images * served_image_least_s(cfg, work["n_edges"]) / work["trace"]["stretch_s"]
