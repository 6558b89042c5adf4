"""The discrete VAE of dwave-examples/image-generation in plain f32 PyTorch.

Weights are a dict keyed as the reference model's ``dvae.pth``.  Encoder:
four Conv3x3(pad 1) -> BatchNorm -> MaxPool2 -> LeakyReLU(0.01) blocks (the
last LeakyReLU dropped), channels 1-32-64-128-n, then each latent's 2x2 map
projected 4 -> 1.  Spins: +1 with probability sigmoid(2 logit), with the
straight-through gradient.  Decoder: Linear(n -> 4n) to an (n, 2, 2) map,
four ConvTranspose3x3(pad 1) -> BatchNorm -> Dropout2d(0.2) -> Upsample x2
(nearest) -> LeakyReLU blocks, channels n-128-64-32-1, and a last
ConvTranspose3x3(1 -> 1).  BatchNorm in training normalises with the batch
statistics as Flax does (variance max(E[x^2] - E[x]^2, 0), eps 1e-5);
in evaluation with the running averages.

``init_weights`` is the training program's initialiser written out again:
LeCun-normal truncated at two deviations (drawn by redrawing outside
them, from one CPU generator, layer by layer in the model's order), zero
biases, unit BatchNorm scales.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["init_weights", "encode", "decode", "straight_through", "dropout_masks",
           "CONV_KEYS", "DECONV_KEYS"]

ENC = "_encoder.conv"
DEC = "_decoder.convtrans"
CONV_KEYS = (0, 4, 8, 12)           # encoder convs; BatchNorm at k + 1
DECONV_KEYS = (0, 5, 10, 15)        # decoder blocks; BatchNorm at k + 1
LAST_DECONV = 20
DROP_CHANNELS = (128, 64, 32, 1)
EPS = 1e-5


def _shapes(n: int):
    """(name, weight shape, fan-in) of every weighted layer, in the model's order."""
    chans = (1, 32, 64, 128, n)
    out = [(f"{ENC}.{k}", (chans[i + 1], chans[i], 3, 3), chans[i] * 9)
           for i, k in enumerate(CONV_KEYS)]
    out.append(("_encoder.projection", (1, 4), 4))
    out.append(("_decoder.increase_latent_dim", (4 * n, n), n))
    dchans = (n, 128, 64, 32, 1)
    out += [(f"{DEC}.{k}", (dchans[i], dchans[i + 1], 3, 3), dchans[i] * 9)
            for i, k in enumerate(DECONV_KEYS)]
    out.append((f"{DEC}.{LAST_DECONV}", (1, 1, 3, 3), 9))
    return out


def init_weights(n: int, seed: int, device) -> dict:
    g = torch.Generator().manual_seed(int(seed))
    w = {}
    for name, shape, fan_in in _shapes(n):
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        t = torch.randn(shape, generator=g)
        out = t.abs() > 2.0
        while out.any():
            t[out] = torch.randn(int(out.sum()), generator=g)
            out = t.abs() > 2.0
        w[f"{name}.weight"] = (t * std).to(device)
        w[f"{name}.bias"] = torch.zeros(shape[1] if "convtrans" in name else shape[0],
                                        device=device)
    for prefix, keys, chans in ((ENC, CONV_KEYS, (32, 64, 128, n)),
                                (DEC, DECONV_KEYS, (128, 64, 32, 1))):
        for k, c in zip(keys, chans):
            w[f"{prefix}.{k + 1}.weight"] = torch.ones(c, device=device)
            w[f"{prefix}.{k + 1}.bias"] = torch.zeros(c, device=device)
            w[f"{prefix}.{k + 1}.running_mean"] = torch.zeros(c, device=device)
            w[f"{prefix}.{k + 1}.running_var"] = torch.ones(c, device=device)
    return w


def _bn(x, w, key, train: bool):
    gamma, beta = w[f"{key}.weight"], w[f"{key}.bias"]
    if train:
        mean, mean2 = x.mean((0, 2, 3)), (x * x).mean((0, 2, 3))
        var = torch.clamp(mean2 - mean * mean, min=0.0)
    else:
        mean, var = w[f"{key}.running_mean"], w[f"{key}.running_var"]
    mul = torch.rsqrt(var + EPS) * gamma
    return (x - mean[:, None, None]) * mul[:, None, None] + beta[:, None, None]


def encode(w, images, train: bool = True):
    """(B, H, W, 1) images -> (B, n) logits."""
    x = images.permute(0, 3, 1, 2)
    for i, k in enumerate(CONV_KEYS):
        x = F.conv2d(x, w[f"{ENC}.{k}.weight"], w[f"{ENC}.{k}.bias"], padding=1)
        x = F.max_pool2d(_bn(x, w, f"{ENC}.{k + 1}", train), 2)
        if i < 3:
            x = F.leaky_relu(x, 0.01)
    x = F.linear(x.flatten(-2, -1), w["_encoder.projection.weight"],
                 w["_encoder.projection.bias"])
    return x.flatten(1)


def straight_through(logits, u):
    """(B, n) logits, (B, R, n) uniforms -> (B, R, n) spins with identity gradient."""
    soft = logits[:, None, :]
    hard = torch.where(u < torch.sigmoid(2.0 * logits)[:, None, :], 1.0, -1.0)
    return soft + (hard - soft).detach()


def dropout_masks(n: int, generator, device):
    """The four (n, C) channel multipliers of Dropout2d(0.2), in draw order."""
    return [(torch.rand((n, c), generator=generator, device=device) >= 0.2).float() / 0.8
            for c in DROP_CHANNELS]


def decode(w, spins, masks=None, train: bool = True):
    """(B, R, n) spins -> (B, R, H, W, 1) images; ``masks`` in training."""
    b, r, n = spins.shape
    x = F.linear(spins, w["_decoder.increase_latent_dim.weight"],
                 w["_decoder.increase_latent_dim.bias"]).reshape(b * r, n, 2, 2)
    for i, k in enumerate(DECONV_KEYS):
        x = F.conv_transpose2d(x, w[f"{DEC}.{k}.weight"], w[f"{DEC}.{k}.bias"], padding=1)
        x = _bn(x, w, f"{DEC}.{k + 1}", train)
        if train:
            x = x * masks[i][:, :, None, None]
        x = F.leaky_relu(F.interpolate(x, scale_factor=2, mode="nearest"), 0.01)
    x = F.conv_transpose2d(x, w[f"{DEC}.{LAST_DECONV}.weight"],
                           w[f"{DEC}.{LAST_DECONV}.bias"], padding=1)
    return x.reshape(b, r, *x.shape[-2:], 1)
