"""Training configuration: the reference's YAML schema as one dataclass.

Port of ``image_generation_tpu/config.py``: the same field names, defaults
and ``__post_init__`` validation, so a parameters YAML or an override dict
means the same thing to both packages.  The dtype policies return torch
dtypes.  ``yaml`` is imported only by ``from_yaml`` / ``to_yaml`` (which
raise an error naming PyYAML where it is absent): the serving path never
reads a YAML file.  ``parse_overrides`` types ``KEY=VAL`` strings as
``yaml.safe_load`` would, without PyYAML (``_yaml_value``).
"""

from __future__ import annotations

import codecs
import dataclasses
import datetime
import math
import re
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
        yaml = _pyyaml()
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in known}
        kwargs.update(overrides)
        return cls(**kwargs)

    @classmethod
    def parse_overrides(cls, pairs) -> dict:
        """``--override KEY=VAL`` strings → constructor kwargs, each value
        typed as ``yaml.safe_load`` types it (``PT_NUM_BETAS=32`` → int,
        ``PT_BETAS=[0.5,1]`` → list, ``GRAPH_SHARDED=on`` → True, which
        ``__post_init__`` turns back into "on"); unknown keys and a missing
        '=' fail here."""
        known = {f.name for f in dataclasses.fields(cls)}
        out = {}
        for ov in pairs or []:
            k, sep, v = ov.partition("=")
            if not sep or not k:
                raise SystemExit(f"--override must be KEY=VAL, got {ov!r}")
            if k not in known:
                raise SystemExit(f"--override: {k!r} is not a TrainingConfig field")
            out[k] = _yaml_value(v)
        return out

    def to_yaml(self, path) -> None:
        yaml = _pyyaml()
        d = dataclasses.asdict(self)
        d["H_RANGE"] = list(self.H_RANGE)
        d["J_RANGE"] = list(self.J_RANGE)
        if self.PT_BETAS is not None:
            d["PT_BETAS"] = list(self.PT_BETAS)
        Path(path).write_text(yaml.safe_dump(d, sort_keys=False))

    def replace(self, **kw) -> "TrainingConfig":
        return dataclasses.replace(self, **kw)


def _pyyaml():
    """The ``yaml`` module, or an error that says reading or writing a
    parameters YAML (``--params``) needs PyYAML."""
    try:
        import yaml
    except ImportError:
        raise ModuleNotFoundError(
            "a training-parameters YAML file (--params, TrainingConfig.from_yaml / to_yaml) "
            "needs PyYAML, which is not installed; pass the settings as CLI flags "
            "instead") from None
    return yaml


# YAML 1.1 implicit scalar types, as PyYAML's resolver matches them
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_DATE = re.compile(r"^[0-9]{4}-[0-9]{2}-[0-9]{2}$")
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]")


def _sexagesimal(text: str, cast):
    value, base = cast(0), 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _signed(text: str):
    text = text.replace("_", "")
    if text[0] in "+-":
        return (-1 if text[0] == "-" else 1), text[1:]
    return 1, text


def _plain_scalar(text: str):
    """A plain (unquoted) scalar typed by YAML 1.1's implicit rules."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        sign, t = _signed(text)
        if t == "0":
            return 0
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if t[0] == "0":
            return sign * int(t, 8)
        if ":" in t:
            return sign * _sexagesimal(t, int)
        return sign * int(t)
    if _FLOAT.match(text):
        sign, t = _signed(text.lower())
        if t == ".inf":
            return sign * math.inf
        if t == ".nan":
            return math.nan
        if ":" in t:
            return sign * _sexagesimal(t, float)
        return sign * float(t)
    if _DATE.match(text):
        return datetime.date.fromisoformat(text)
    if _TIMESTAMP.match(text):
        raise SystemExit(f"--override: timestamp values are not taken, got {text!r}")
    return text


def _split_flow(body: str) -> list:
    """Top-level comma-separated items of a flow collection's body."""
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    items.append(body[start:])
    if items and not items[-1].strip():  # a trailing comma ends the collection
        items.pop()
    return items


def _yaml_value(text: str):
    """What ``yaml.safe_load`` gives for one override value: plain scalars
    (YAML 1.1 bools, ints in every base, floats only with a '.', nulls,
    dates), quoted strings, and flow sequences / mappings of those."""
    text = text.strip()
    if text.startswith("#"):
        return None
    if text and text[0] in "[{":
        body, close = text[1:].rstrip(), "]" if text[0] == "[" else "}"
        if not body.endswith(close):
            raise SystemExit(f"--override: unterminated flow collection {text!r}")
        items = _split_flow(body[:-1])
        if close == "]":
            return [_yaml_value(item) for item in items]
        out = {}
        for item in items:
            k, sep, v = item.partition(":")
            out[_yaml_value(k)] = _yaml_value(v) if sep else None
        return out
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return codecs.decode(text[1:-1], "unicode_escape")
    text = re.split(r"\s#", text, maxsplit=1)[0].rstrip()
    return _plain_scalar(text)
