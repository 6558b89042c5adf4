"""Port parity: the DVAE modules and the weight loaders.

Both packages load the same ``dvae.pth``: the JAX package through its
converter, the port through ``load_state_dict`` (its modules have the
reference's state-dict layout).  Eval mode, float32, on the CPU; outputs
agree to 1e-4 absolute (the two frameworks order convolution sums
differently).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_generation_tpu.io.checkpoint import load_model_dir as jax_load_model_dir
from image_generation_tpu.models.dvae import DVAE as JaxDVAE
from image_generation_tpu_torch.io.checkpoint import load_model_dir
from image_generation_tpu_torch.io.torch_pth import dvae_state_dict_from_jax, grbm_from_jax
from image_generation_tpu_torch.models.dvae import (
    DVAE,
    gumbel_spins,
    heaviside_spins,
    spins_straight_through,
)

MODEL = Path(__file__).resolve().parent.parent / "runs" / "models" / "tpu_digits_40_epochs"
ATOL = 1e-4


@pytest.fixture(scope="module")
def shipped():
    params, stats, *_ = jax_load_model_dir(MODEL)
    sd, *_ = load_model_dir(MODEL)
    port = DVAE(256)
    port.load_state_dict(sd)
    return {"params": params, "batch_stats": stats}, port.eval()


def _images(seed, b=4):
    rng = np.random.RandomState(seed)
    return np.round(rng.rand(b, 32, 32, 1)).astype(np.float32)  # binarized like MNIST


def _spins(seed, b, r, n):
    return np.random.RandomState(seed).choice([-1.0, 1.0], (b, r, n)).astype(np.float32)


def test_state_dict_keys_are_the_reference_layout(shipped):
    _, port = shipped
    sd, *_ = load_model_dir(MODEL)
    assert set(port.state_dict()) == set(sd)


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_matches_jax(shipped, seed):
    variables, port = shipped
    x = _images(seed)
    ref = JaxDVAE(n_latents=256).apply(variables, jnp.asarray(x), method="encode")
    with torch.no_grad():
        ours = port.encode(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("b,r", [(2, 3), (8, 1)])
def test_decode_matches_jax(shipped, b, r):
    variables, port = shipped
    z = _spins(b * 10 + r, b, r, 256)
    ref = JaxDVAE(n_latents=256).apply(variables, jnp.asarray(z), method="decode")
    with torch.no_grad():
        ours = port.decode(torch.from_numpy(z))
    assert ours.shape == (b, r, 32, 32, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_heaviside_forward_matches_jax(shipped):
    variables, port = shipped
    x = _images(5, 3)
    ref = JaxDVAE(n_latents=256, latent_to_discrete="heaviside").apply(
        variables, jnp.asarray(x), n_replicas=1)
    hv = DVAE(256, "heaviside")
    hv.load_state_dict(port.state_dict())
    with torch.no_grad():
        ours = hv.eval()(torch.from_numpy(x))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=ATOL)


def test_spin_modes():
    logits = torch.tensor([[-1.0, 0.0, 2.0]])
    np.testing.assert_array_equal(heaviside_spins(logits, 1).numpy(), [[[-1.0, -1.0, 1.0]]])
    with pytest.raises(ValueError):
        heaviside_spins(logits, 2)
    g = torch.Generator().manual_seed(1)
    s = spins_straight_through(torch.full((1, 512), 0.5), 64, g)
    assert s.shape == (1, 64, 512) and set(s.unique().tolist()) <= {-1.0, 1.0}
    assert abs(float((s == 1).float().mean()) - float(torch.sigmoid(torch.tensor(1.0)))) < 0.02
    r = gumbel_spins(torch.full((2, 512), 0.5), 4, g, tau=0.7)
    # relaxed: in [-1, 1], and only noise far out in the tail rounds tanh to ±1 in f32
    assert r.shape == (2, 4, 512) and bool((r.abs() <= 1).all())
    assert float((r.abs() < 1).float().mean()) > 0.95
    assert abs(float((r > 0).float().mean()) - float(torch.sigmoid(torch.tensor(1.0)))) < 0.03
    assert DVAE(16, "gumbel", gumbel_tau=0.7).gumbel_tau == 0.7
    with pytest.raises(ValueError, match="Invalid Mode"):
        DVAE(16, "softmax")


def test_dvae_state_dict_from_jax_gives_same_decode():
    """Weights carried from a randomly initialised small flax DVAE: the
    port decodes the same images."""
    jd = JaxDVAE(n_latents=16)
    variables = jd.init(
        {"params": jax.random.PRNGKey(0), "spins": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 1)), n_replicas=1,
    )
    # non-trivial running statistics, so the BatchNorm map is exercised
    stats = jax.tree.map(
        lambda a: a + 0.1 * np.random.RandomState(a.size).rand(*a.shape).astype(np.float32),
        variables["batch_stats"])
    port = DVAE(16)
    port.load_state_dict(dvae_state_dict_from_jax(variables["params"], stats))
    z = _spins(3, 4, 2, 16)
    x = _images(4, 2)
    vs = {"params": variables["params"], "batch_stats": stats}
    with torch.no_grad():
        np.testing.assert_allclose(
            port.eval().decode(torch.from_numpy(z)).numpy(),
            np.asarray(jd.apply(vs, jnp.asarray(z), method="decode")), rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            port.encode(torch.from_numpy(x)).numpy(),
            np.asarray(jd.apply(vs, jnp.asarray(x), method="encode")), rtol=0, atol=ATOL)


def test_grbm_loads_from_checkpoint_and_from_jax():
    *_, jparams, jgraph, _, _ = jax_load_model_dir(MODEL)
    _, params, graph, parameters, losses = load_model_dir(MODEL)
    assert parameters["n_latents"] == 256 and "mse_losses" in losses
    np.testing.assert_array_equal(params.linear.numpy(), np.asarray(jparams.linear))
    np.testing.assert_array_equal(params.quadratic.numpy(), np.asarray(jparams.quadratic))
    np.testing.assert_array_equal(graph.edge_i, jgraph.edge_i)
    np.testing.assert_array_equal(graph.edge_j, jgraph.edge_j)
    p2, g2 = grbm_from_jax(np.asarray(jparams.linear), np.asarray(jparams.quadratic),
                           jgraph.edge_i, jgraph.edge_j)
    assert torch.equal(p2.linear, params.linear) and g2.n == graph.n == 256
