"""Readings of a traced stretch that several per-layer metrics share."""

from __future__ import annotations

from typing import Optional

from yardstick.work import sweep_bound_s

# the sampler's kernels, by the names the program gives them: the sweep and
# the neighbour-table pass every sweep launch runs
GATHER_KERNELS = ("sparse_sweeps_kernel", "gather_table_kernel")


class NothingRead(RuntimeError):
    """A reader found nothing where the program says there was work."""


def gather_seconds(work: dict) -> Optional[float]:
    """Device seconds of the gather's kernels in the stretch; None where
    the program launched none there; an error where it did and the
    profiler saw none."""
    trace = work.get("trace")
    if not trace:
        return None
    secs = sum(v for k, v in trace["kernel_s"].items() if any(g in k for g in GATHER_KERNELS))
    if secs > 0:
        return secs
    if work.get("gather_launches", 0) > 0:
        raise NothingRead(f"{work['gather_launches']} gather launches counted in the traced "
                          "stretch, and none of their kernels in the profiler's trace")
    return None


def gather_roofline(work: dict, launches) -> Optional[float]:
    """100 x the least time of ``launches`` [(chains, sweeps, delta_e), ...]
    over the gather's device time."""
    secs = gather_seconds(work)
    if secs is None or not launches:
        return None
    cfg = work["config"]
    bound = sum(sweep_bound_s(cfg["N_LATENTS"], work["n_edges"], c, s,
                              cfg["SAMPLER_MATMUL_DTYPE"], de) for c, s, de in launches)
    return 100.0 * bound / secs


def idle_pct(work: dict) -> Optional[float]:
    trace = work.get("trace")
    if not trace or trace["stretch_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["stretch_s"])
