"""The work of a training step and of a served image, counted from the
model's shapes, and the least time the H100 could take for it.

Nothing here reads the program: the counts come from the configuration's
sizes (latents, batch, replicas, chains, sweeps) and the graph's edges.

DVAE (see ``reference/dvae.py``): 2 FLOPs a multiply-add of every
convolution, transposed convolution and dense layer; elementwise work,
BatchNorm and pooling are not counted.  A training step runs the encoder
once an image and the decoder once a replica, forward and backward
(3x the forward).  MMD: the joint Gram matrix of the (B*R + C) spins,
forward and backward (3x).  Sampler: 2 operations a nonzero of the
symmetric coupling (both directions of an edge) a chain a sweep.
"""

from __future__ import annotations

from yardstick import peaks

__all__ = ["encoder_flops", "decoder_flops", "train_step_least_s", "served_image_least_s",
           "sweep_bound_s"]


def encoder_flops(n: int, size: int = 32) -> float:
    chans = (1, 32, 64, 128, n)
    flops, side = 0.0, size
    for i in range(4):
        flops += 2 * 9 * chans[i] * chans[i + 1] * side * side
        side //= 2
    return flops + 2 * 4 * n  # the 4 -> 1 projection of each latent's map


def decoder_flops(n: int, size: int = 32) -> float:
    flops = 2.0 * n * 4 * n  # Linear(n -> 4n)
    chans, side = (n, 128, 64, 32, 1), size // 16
    for i in range(4):
        flops += 2 * 9 * chans[i] * chans[i + 1] * side * side
        side *= 2
    return flops + 2 * 9 * side * side  # the last ConvTranspose(1 -> 1)


def sweep_ops(n_edges: int, chains: int, sweeps: int) -> float:
    return 2.0 * (2 * n_edges) * chains * sweeps


def train_step_least_s(cfg: dict, n_edges: int, grbm_update: bool) -> float:
    """Least time of one step: each class of work at its dtype's peak."""
    n, b, r = cfg["N_LATENTS"], cfg["BATCH_SIZE"], cfg["N_REPLICAS"]
    dvae = 3.0 * b * (encoder_flops(n, cfg["IMAGE_SIZE"]) + r * decoder_flops(n, cfg["IMAGE_SIZE"]))
    rungs = cfg["PT_NUM_BETAS"] if cfg["SAMPLER"] == "pt" else 1
    samples = cfg["NUM_READS"]
    m = b * r + samples
    mmd = 3.0 * 2.0 * m * m * n
    phases = 2 if grbm_update else 1
    sampler = phases * sweep_ops(n_edges, rungs * samples, cfg["GIBBS_SWEEPS"])
    dvae_peak = peaks.BF16_FLOP_S if cfg["COMPUTE_DTYPE"] == "bfloat16" else peaks.F32_FLOP_S
    return dvae / dvae_peak + mmd / peaks.F32_FLOP_S + sampler / peaks.F32_FLOP_S


def served_image_least_s(cfg: dict, n_edges: int) -> float:
    """Least time of one served image: its chain's sweeps and its decode."""
    n = cfg["N_LATENTS"]
    sweeps = cfg["GIBBS_BURN_IN"] + cfg["GIBBS_SWEEPS"]
    dvae_peak = peaks.BF16_FLOP_S if cfg["COMPUTE_DTYPE"] == "bfloat16" else peaks.F32_FLOP_S
    return (sweep_ops(n_edges, 1, sweeps) / peaks.F32_FLOP_S
            + decoder_flops(n, cfg["IMAGE_SIZE"]) / dvae_peak)


def sweep_bound_s(n: int, n_edges: int, chains: int, sweeps: int, coupling: str,
                  delta_e: bool) -> float:
    """Least time of one sweep run of ``chains`` chains: the field products
    at the sweep's peak, against every input read once and every output
    written once at HBM bandwidth (f32 spins in and out, each nonzero of
    the coupling once in its stored type, the fields, a beta a chain, the
    64-bit seed, and an energy change a chain when it is carried)."""
    ops = sweep_ops(n_edges, chains, sweeps)
    nbytes = (4.0 * (2 * chains * n + n + chains) + 8
              + 2 * n_edges * peaks.COUPLING_BYTES[coupling]
              + (4.0 * chains if delta_e else 0.0))
    return max(ops / peaks.SWEEP_OP_S[coupling], nbytes / peaks.HBM_BYTES_S)
