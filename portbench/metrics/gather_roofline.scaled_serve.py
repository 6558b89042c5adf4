"""The int8 gather (K3 on the scaled plan's packed panels) in serving: its
frozen bound, with the coupling stored as int8, over its device time.  One
launch a dispatch: every request's chains, burn-in and sweeps."""

from yardstick.trace_reads import gather_roofline


def read(run, work):
    cfg = work["config"]
    sweeps = cfg["GIBBS_BURN_IN"] + cfg["GIBBS_SWEEPS"]
    return gather_roofline(work, [(k * cfg["NUM_READS"], sweeps, False)
                                  for k in work.get("dispatches", [])])
