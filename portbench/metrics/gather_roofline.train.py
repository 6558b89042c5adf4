"""The sampler's gather in training: its frozen bound over its device time.
One launch a negative phase: every rung's chains, the step's sweeps, the
energy change carried; a scheduled update of the Boltzmann machine adds one."""

from yardstick.trace_reads import gather_roofline


def read(run, work):
    cfg = work["config"]
    pt = cfg["SAMPLER"] == "pt"
    chains = (cfg["PT_NUM_BETAS"] if pt else 1) * cfg["NUM_READS"]
    launches = [(chains, cfg["GIBBS_SWEEPS"], pt)
                for grbm in work.get("steps", []) for _ in range(2 if grbm else 1)]
    return gather_roofline(work, launches)
