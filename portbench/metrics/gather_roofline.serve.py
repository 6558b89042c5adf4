"""The sampler's gather in serving: its frozen bound over its device time.
One launch a dispatch: every request's chains, burn-in and sweeps."""

from yardstick.trace_reads import gather_roofline


def read(run, work):
    cfg = work["config"]
    sweeps = cfg["GIBBS_BURN_IN"] + cfg["GIBBS_SWEEPS"]
    return gather_roofline(work, [(k * cfg["NUM_READS"], sweeps, False)
                                  for k in work.get("dispatches", [])])
