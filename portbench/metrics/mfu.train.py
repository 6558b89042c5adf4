"""Model FLOP utilisation of training: the least time of the traced steps'
DVAE, MMD and sampler work at the H100's peaks, over the stretch."""

from yardstick.work import train_step_least_s


def read(run, work):
    if not work.get("trace") or not work.get("steps"):
        return None
    least = sum(train_step_least_s(work["config"], work["n_edges"], g) for g in work["steps"])
    return 100.0 * least / work["trace"]["stretch_s"]
