"""Training configuration: the reference's YAML schema as one dataclass.

Port of ``image_generation_tpu/config.py``: the same field names, defaults
and ``__post_init__`` validation, so a parameters YAML or an override dict
means the same thing to both packages.  The dtype policies return torch
dtypes.  ``yaml`` is imported only by ``from_yaml`` / ``to_yaml``: the
serving path never reads a YAML file.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

__all__ = ["TrainingConfig", "SERVING_INT8_MIN_LATENTS"]

# Scale gate for the serving-surface int8 default (``for_serving``): the
# same 2048-latent threshold as the JAX package.
SERVING_INT8_MIN_LATENTS = 2048


@dataclass
class TrainingConfig:
    # --- reference training_parameters.yaml keys (same defaults) ---
    ANNEALING_TIME: float = 1.0
    NUM_READS: int = 256
    IMAGE_SIZE: int = 32
    DATASET_SIZE: Optional[int] = None
    BATCH_SIZE: int = 128
    RANDOM_SEED: int = 775321899904
    LOSS_FUNCTION: str = "mmd"
    N_REPLICAS: int = 8
    LATENT_TO_DISCRETE: Optional[str] = None  # None | "heaviside" | "gumbel"
    GUMBEL_TAU: float = 1.0
    PREFACTOR: float = 0.05
    MAX_DEQUE_SIZE: int = 4096
    ITERATIONS_BEFORE_RESAMPLING: int = 100
    AUTOENCODER_INITIAL_LR: float = 1e-4
    AUTOENCODER_FINAL_LR: float = 1e-5
    AUTOENCODER_WEIGHT_DECAY: float = 0.01
    BM_INITIAL_LR: float = 1e-3
    BM_FINAL_LR: float = 1e-4
    BM_WEIGHT_DECAY: float = 0.01

    # --- sampler settings (see the JAX config for each knob's meaning) ---
    SAMPLER: str = "gibbs"  # "gibbs" | "pt" | "exact"
    GIBBS_SWEEPS: int = 16
    GIBBS_BURN_IN: int = 64
    PERSISTENT_CHAINS: bool = True
    PT_NUM_BETAS: int = 8  # or "auto": the Trainer sizes the ladder by a
    # swap-acceptance probe (ops/pt_tune.size_ladder) and freezes PT_BETAS
    PT_BETA_MIN: float = 0.25
    PT_BETAS: Optional[tuple] = None
    PT_ADAPT: str = "off"  # "off" | "epoch"
    N_KERNELS: int = 7
    COMPUTE_DTYPE: str = "bfloat16"  # decode precision on the GPU (autocast)
    SAMPLER_MATMUL_DTYPE: str = "auto"  # "auto" | "float32" | "bfloat16" | "int8"
    ADAM_MOMENT_DTYPE: str = "float32"
    ADAM_FACTORED_NU: str = "off"
    USE_PALLAS: str = "auto"  # "auto"/"on": the hand-written sweep kernel
    # on CUDA tensors; "off": the plain PyTorch sweep
    PLRNG_ROW_SEED: str = "off"
    SWEEP_BLOCK_SPARSE: str = "auto"
    SWEEP_BS_CHUNK: int = 256
    GRAPH_SHARDED: str = "auto"

    # --- model/problem shape ---
    QPU: str = "Advantage2_system1"
    N_LATENTS: int = 256

    # hardware parameter ranges used when clipping the sampled model
    H_RANGE: tuple = (-4.0, 4.0)
    J_RANGE: tuple = (-1.0, 1.0)

    def __post_init__(self):
        # YAML 1.1 parses bare on/off as booleans: normalize them to the
        # string form and fail loudly on anything else
        for field in ("GRAPH_SHARDED", "USE_PALLAS", "SWEEP_BLOCK_SPARSE"):
            v = getattr(self, field)
            if isinstance(v, bool):
                v = "on" if v else "off"
                object.__setattr__(self, field, v)
            if v not in ("auto", "on", "off"):
                raise ValueError(
                    f"{field} must be one of 'auto'/'on'/'off', got {v!r}"
                )
        for field in ("ADAM_FACTORED_NU", "PLRNG_ROW_SEED"):
            v = getattr(self, field)
            if isinstance(v, bool):
                v = "on" if v else "off"
                object.__setattr__(self, field, v)
            if v not in ("on", "off"):
                raise ValueError(f"{field} must be 'on' or 'off', got {v!r}")
        if self.ADAM_MOMENT_DTYPE not in ("float32", "bfloat16"):
            raise ValueError(
                "ADAM_MOMENT_DTYPE must be 'float32' or 'bfloat16', got "
                f"{self.ADAM_MOMENT_DTYPE!r}"
            )
        if self.SAMPLER_MATMUL_DTYPE not in (
            "auto", "float32", "bfloat16", "int8"
        ):
            raise ValueError(
                "SAMPLER_MATMUL_DTYPE must be 'auto'/'float32'/'bfloat16'/"
                f"'int8', got {self.SAMPLER_MATMUL_DTYPE!r}"
            )
        if self.PT_BETAS is not None:
            b = tuple(float(x) for x in self.PT_BETAS)
            if len(b) < 2 or any(
                b2 <= b1 for b1, b2 in zip(b, b[1:])
            ) or b[0] <= 0 or abs(b[-1] - 1.0) > 1e-6:
                raise ValueError(
                    "PT_BETAS must be an ascending ladder of ≥2 positive "
                    f"rungs ending at 1.0, got {self.PT_BETAS!r}"
                )
            object.__setattr__(self, "PT_BETAS", b)
            object.__setattr__(self, "PT_NUM_BETAS", len(b))
        v = self.PT_NUM_BETAS
        if isinstance(v, str):
            if v != "auto":
                raise ValueError(
                    f"PT_NUM_BETAS must be an int ≥ 2 or 'auto', got {v!r}"
                )
        elif not isinstance(v, int) or v < 2:
            raise ValueError(
                f"PT_NUM_BETAS must be an int ≥ 2 or 'auto', got {v!r}"
            )
        if isinstance(self.PT_ADAPT, bool):
            object.__setattr__(self, "PT_ADAPT", "epoch" if self.PT_ADAPT else "off")
        if self.PT_ADAPT not in ("off", "epoch"):
            raise ValueError(
                f"PT_ADAPT must be 'off' or 'epoch', got {self.PT_ADAPT!r}"
            )

    def initial_pt_betas(self):
        """The initial parallel-tempering ladder as a float64 numpy array:
        ``PT_BETAS`` if set, else geometric over [PT_BETA_MIN, 1]."""
        import numpy as np

        if self.PT_BETAS is not None:
            return np.asarray(self.PT_BETAS, np.float64)
        if self.PT_NUM_BETAS == "auto":
            raise RuntimeError(
                "PT_NUM_BETAS='auto' has not been resolved yet: the Trainer "
                "sizes the ladder at train_init/load (or pass an explicit "
                "PT_BETAS ladder)"
            )
        return np.geomspace(self.PT_BETA_MIN, 1.0, self.PT_NUM_BETAS)

    def for_serving(self, n_latents: int) -> "TrainingConfig":
        """Serving-surface resolution: under ``SAMPLER_MATMUL_DTYPE="auto"``
        models of at least ``SERVING_INT8_MIN_LATENTS`` latents serve from
        the int8-quantized sampler; an explicit dtype is kept."""
        if (
            self.SAMPLER_MATMUL_DTYPE == "auto"
            and n_latents >= SERVING_INT8_MIN_LATENTS
        ):
            return self.replace(SAMPLER_MATMUL_DTYPE="int8")
        return self

    def for_serving_dir(self, model_dir) -> "TrainingConfig":
        """``for_serving`` with the scale read from the checkpoint's own
        ``parameters.json`` (falling back to this config's N_LATENTS)."""
        from image_generation_tpu_torch.io.checkpoint import read_parameters

        return self.for_serving(
            int(read_parameters(model_dir).get("n_latents", self.N_LATENTS))
        )

    def resolved_sampler_matmul_dtype(self, n_pad: int):
        """The sweep-matmul dtype for a graph padded to ``n_pad``:
        ``torch.bfloat16`` under "auto" from n_pad 2048, an explicit
        bfloat16, or None for f32 and for "int8" (int8 is carried by the
        quantized coupling itself, as in the JAX package)."""
        if self.SAMPLER_MATMUL_DTYPE == "auto":
            return torch.bfloat16 if n_pad >= 2048 else None
        if self.SAMPLER_MATMUL_DTYPE in ("float32", "int8"):
            return None
        return torch.bfloat16

    def resolved_block_sparse(self, plan) -> bool:
        """Whether the packed block-sparse coupling applies to ``plan``:
        "on", or under "auto" a plan of n_pad ≥ 2048 whose chunk occupancy
        at ``SWEEP_BS_CHUNK`` is at most 0.75 (the JAX package's gate)."""
        if self.SWEEP_BLOCK_SPARSE == "off":
            return False
        if self.SWEEP_BLOCK_SPARSE == "on":
            return True
        from image_generation_tpu_torch.ops.block_sparse import chunk_occupancy

        return plan.n_pad >= 2048 and chunk_occupancy(plan, self.SWEEP_BS_CHUNK) <= 0.75

    @classmethod
    def from_yaml(cls, path, **overrides) -> "TrainingConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in known}
        kwargs.update(overrides)
        return cls(**kwargs)

    def to_yaml(self, path) -> None:
        import yaml

        d = dataclasses.asdict(self)
        d["H_RANGE"] = list(self.H_RANGE)
        d["J_RANGE"] = list(self.J_RANGE)
        if self.PT_BETAS is not None:
            d["PT_BETAS"] = list(self.PT_BETAS)
        Path(path).write_text(yaml.safe_dump(d, sort_keys=False))

    def replace(self, **kw) -> "TrainingConfig":
        return dataclasses.replace(self, **kw)
