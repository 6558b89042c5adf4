"""The reference's ``.pth`` tensor format, and weights carried from JAX.

Port of ``image_generation_tpu/io/torch_pth.py``.  The port's DVAE module
has the reference's state-dict layout, so ``dvae.pth`` needs no converter;
``grbm.pth`` becomes ``GRBMParams`` + ``GRBMGraph``.

``dvae_state_dict_from_jax`` / ``grbm_from_jax`` turn the JAX package's
parameters, as numpy arrays, into the port's: the first is the inverse of
the JAX converter's key map (flax HWIO kernels → torch OIHW; the decoder's
flipped HWIO conv kernels → ``ConvTranspose2d`` (I, O, kh, kw) weights).
A whole training state is carried by ``training.step.train_state_from_jax``.

Writing: ``dvae_state_dict`` (the module's own state dict on the CPU),
``grbm_state_dict`` and ``save_state_dict`` give the files the JAX package
and the reference read.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from image_generation_tpu_torch.models.grbm import GRBMGraph, GRBMParams

__all__ = [
    "load_state_dict",
    "save_state_dict",
    "dvae_state_dict",
    "grbm_state_dict",
    "grbm_from_state_dict",
    "grbm_from_jax",
    "dvae_state_dict_from_jax",
]

_ENC_CONV_IDS = (0, 4, 8, 12)  # nn.Sequential indices of the Conv2d layers
_ENC_BN_IDS = (1, 5, 9, 13)
_DEC_CONV_IDS = (0, 5, 10, 15, 20)  # 5 ConvTranspose2d layers
_DEC_BN_IDS = (1, 6, 11, 16)


def load_state_dict(path) -> Dict[str, torch.Tensor]:
    """Read a ``.pth`` state dict (tensors only) onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_state_dict(path, sd: Dict[str, torch.Tensor]) -> None:
    """Write a state dict of CPU tensors as a ``.pth`` file."""
    torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()}, path)


def dvae_state_dict(dvae: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The DVAE's ``dvae.pth`` tensors (its state dict on the CPU, f32,
    ``num_batches_tracked`` 0 as the JAX writer stores it)."""
    sd = {}
    for k, v in dvae.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.int64)
        else:
            sd[k] = v.detach().to("cpu", torch.float32)
    return sd


def grbm_state_dict(params: GRBMParams, graph: GRBMGraph) -> Dict[str, torch.Tensor]:
    """(GRBMParams, GRBMGraph) → the ``grbm.pth`` tensors."""
    empty = torch.zeros(0, dtype=torch.int64)
    return {
        "_linear": params.linear.detach().to("cpu", torch.float32),
        "_quadratic": params.quadratic.detach().to("cpu", torch.float32),
        "_edge_idx_i": torch.from_numpy(np.asarray(graph.edge_i, np.int64)),
        "_edge_idx_j": torch.from_numpy(np.asarray(graph.edge_j, np.int64)),
        "_visible_idx": torch.from_numpy(graph.visible_idx),
        "_hidden_idx": empty,
        "_flat_adj": empty,
        "_flat_j_idx": empty,
        "_bin_idx": empty,
    }


def grbm_from_jax(linear, quadratic, edge_i, edge_j, device="cpu") -> Tuple[GRBMParams, GRBMGraph]:
    """GRBM parameters and edge lists as arrays → (GRBMParams, GRBMGraph)."""
    linear = np.asarray(linear, np.float32)
    params = GRBMParams(
        linear=torch.tensor(linear, device=device),
        quadratic=torch.tensor(np.asarray(quadratic, np.float32), device=device),
    )
    graph = GRBMGraph(n=linear.shape[0], edge_i=np.asarray(edge_i), edge_j=np.asarray(edge_j))
    return params, graph


def grbm_from_state_dict(sd: Dict[str, torch.Tensor], device="cpu") -> Tuple[GRBMParams, GRBMGraph]:
    """``grbm.pth`` state dict (``_linear`` (n,), ``_quadratic`` (E,),
    ``_edge_idx_i/_edge_idx_j`` (E,)) → (GRBMParams, GRBMGraph)."""
    return grbm_from_jax(
        sd["_linear"].numpy(), sd["_quadratic"].numpy(),
        sd["_edge_idx_i"].numpy(), sd["_edge_idx_j"].numpy(), device=device,
    )


def _hwio_to_conv(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))


def _hwio_to_convt(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def dvae_state_dict_from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """(flax params, flax batch_stats) of the JAX ``DVAE`` → the port's
    DVAE state dict (the reference ``dvae.pth`` layout)."""
    def a(t):
        return np.asarray(t, np.float32)

    sd: Dict[str, np.ndarray] = {}
    enc_p, enc_s = params["encoder"], batch_stats["encoder"]
    for i, cid in enumerate(_ENC_CONV_IDS):
        sd[f"_encoder.conv.{cid}.weight"] = _hwio_to_conv(a(enc_p[f"conv_{i}"]["kernel"]))
        sd[f"_encoder.conv.{cid}.bias"] = a(enc_p[f"conv_{i}"]["bias"])
    for i, bid in enumerate(_ENC_BN_IDS):
        sd[f"_encoder.conv.{bid}.weight"] = a(enc_p[f"bn_{i}"]["scale"])
        sd[f"_encoder.conv.{bid}.bias"] = a(enc_p[f"bn_{i}"]["bias"])
        sd[f"_encoder.conv.{bid}.running_mean"] = a(enc_s[f"bn_{i}"]["mean"])
        sd[f"_encoder.conv.{bid}.running_var"] = a(enc_s[f"bn_{i}"]["var"])
        sd[f"_encoder.conv.{bid}.num_batches_tracked"] = np.asarray(0, np.int64)
    sd["_encoder.projection.weight"] = a(enc_p["projection"]["kernel"]).T
    sd["_encoder.projection.bias"] = a(enc_p["projection"]["bias"])

    dec_p, dec_s = params["decoder"], batch_stats["decoder"]
    sd["_decoder.increase_latent_dim.weight"] = a(dec_p["increase_latent_dim"]["kernel"]).T
    sd["_decoder.increase_latent_dim.bias"] = a(dec_p["increase_latent_dim"]["bias"])
    for i, cid in enumerate(_DEC_CONV_IDS):
        sd[f"_decoder.convtrans.{cid}.weight"] = _hwio_to_convt(a(dec_p[f"convt_{i}"]["kernel"]))
        sd[f"_decoder.convtrans.{cid}.bias"] = a(dec_p[f"convt_{i}"]["bias"])
    for i, bid in enumerate(_DEC_BN_IDS):
        sd[f"_decoder.convtrans.{bid}.weight"] = a(dec_p[f"bn_{i}"]["scale"])
        sd[f"_decoder.convtrans.{bid}.bias"] = a(dec_p[f"bn_{i}"]["bias"])
        sd[f"_decoder.convtrans.{bid}.running_mean"] = a(dec_s[f"bn_{i}"]["mean"])
        sd[f"_decoder.convtrans.{bid}.running_var"] = a(dec_s[f"bn_{i}"]["var"])
        sd[f"_decoder.convtrans.{bid}.num_batches_tracked"] = np.asarray(0, np.int64)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
