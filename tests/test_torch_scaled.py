"""Port parity: the scaled slice's dispatch and one parallel-tempering step
on a packed bf16 / int8 coupling, on the CPU.

Dispatch: the port's ``sampler_impl`` against the JAX package's
``make_train_fns(..., USE_PALLAS="on").sampler_impl`` (built only), with
``pallas`` spelled ``cuda``, including the cases where the JAX package
picks its on-chip kernel with a bf16 or int8 coupling (K1-bf16, K1-int8).

The step: the scaled configuration's sampler settings (bf16 or int8
coupling, packed panels at a chunk that clamps, PT with carried
energies, an even sweep count) on the 32-latent training graph of
tests/test_torch_training.py, from the same state (``train_state_from_jax``)
with the draws of a JAX step at ``USE_PALLAS="off"`` (its XLA packed
sweep).  The port runs its default dispatch, ``cuda_hbm+bs``: on the CPU
the plain version of K3.  Tolerances are that file's: losses rtol 5e-5
(mse, dvae_loss) and 1e-5 (mmd, nll), GRBM parameters 1e-6, chains by the
chain rule (≥ 98 % bit-identical; int8 fields are formed in quantized
units by K3 and as products × scale by the XLA sweep, which round
differently).  The rebuilt packed cache is bit-identical to the JAX
state's panels; carried ladder energies agree with energies recomputed on
the packed coupling within 1e-5·(1 + |E|).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from image_generation_tpu.config import TrainingConfig as JaxConfig
from image_generation_tpu.io.torch_pth import grbm_from_state_dict as jax_grbm_from_sd
from image_generation_tpu.io.torch_pth import load_state_dict as jax_load_sd
from image_generation_tpu.models import grbm as jgrbm
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.training import step as jstep
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.models import grbm as tgrbm
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops.block_sparse import BlockSparseCoupling
from image_generation_tpu_torch.training.step import (
    make_sample_fns,
    make_train_fns,
    train_state_from_jax,
)
from test_torch_training import SMALL, _images, _step_feed, _t, graphs, jax_capture  # noqa: F401

MODEL = Path(__file__).resolve().parent.parent / "runs" / "models" / "tpu_digits_40_epochs"


@pytest.fixture(scope="module")
def grid45():
    """The JAX tests' 45×45 grid (tests/test_block_sparse.py): n_pad 2048,
    where bf16 storage and 'auto' block sparsity both engage."""
    g = nx.grid_2d_graph(45, 45)
    g = nx.relabel_nodes(g, {v: i for i, v in enumerate(sorted(g.nodes()))})
    jg = jgrbm.GRBMGraph.from_networkx(g)
    tg = tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j)
    jplan, tplan = jgibbs.build_plan(jg), tgibbs.build_plan(tg)
    assert jplan.n_pad == tplan.n_pad == 2048
    return jg, jplan, tg, tplan


@pytest.fixture(scope="module")
def flagship():
    _, jg = jax_grbm_from_sd(jax_load_sd(MODEL / "grbm.pth"))
    tg = tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j)
    return jg, jgibbs.build_plan(jg), tg, tgibbs.build_plan(tg)


_GRID = dict(N_LATENTS=2025, NUM_READS=128, BATCH_SIZE=4, N_REPLICAS=2, GIBBS_SWEEPS=2,
             GIBBS_BURN_IN=4, SWEEP_BS_CHUNK=128)
_CASES = {  # name: (graph fixture, overrides, the JAX sampler_impl)
    "flagship": ("flagship", {}, "pallas_vmem"),
    "flagship_pt": ("flagship", dict(SAMPLER="pt"), "pallas_vmem"),
    "flagship_bs_on": ("flagship", dict(SWEEP_BLOCK_SPARSE="on"), "pallas_hbm+bs"),
    "grid_auto": ("grid45", _GRID, "pallas_hbm+bs"),
    "grid_off": ("grid45", dict(_GRID, SWEEP_BLOCK_SPARSE="off", NUM_READS=256), "pallas_hbm"),
    "grid_int8": ("grid45", dict(_GRID, SAMPLER_MATMUL_DTYPE="int8"), "pallas_hbm+int8+bs"),
    "grid_int8_off_pt": ("grid45", dict(_GRID, SAMPLER_MATMUL_DTYPE="int8", SAMPLER="pt",
                                        PT_NUM_BETAS=8, SWEEP_BLOCK_SPARSE="off"),
                         "pallas_vmem+int8"),
    "grid_float32": ("grid45", dict(_GRID, SAMPLER_MATMUL_DTYPE="float32"), "pallas_hbm+bs"),
    "grid_float32_off": ("grid45", dict(_GRID, SAMPLER_MATMUL_DTYPE="float32",
                                        SWEEP_BLOCK_SPARSE="off"), "pallas_hbm"),
    "grid_off_bf16_K1": ("grid45", dict(_GRID, SWEEP_BLOCK_SPARSE="off"), "pallas_vmem"),
    "grid_off_int8_K1": ("grid45", dict(_GRID, SWEEP_BLOCK_SPARSE="off",
                                        SAMPLER_MATMUL_DTYPE="int8"), "pallas_vmem+int8"),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_dispatch_matches_jax(request, case):
    fixture, kw, want = _CASES[case]
    jg, jplan, tg, tplan = request.getfixturevalue(fixture)
    jax_impl = jstep.make_train_fns(JaxConfig(**kw, USE_PALLAS="on"), jg, 10, jplan).sampler_impl
    assert jax_impl == want
    fns = make_sample_fns(TrainingConfig(**kw), tg, tplan, device="cpu")
    assert fns.sampler_impl == jax_impl.replace("pallas", "cuda")
    off = make_sample_fns(TrainingConfig(**kw, USE_PALLAS="off"), tg, tplan, device="cpu")
    jax_off = jstep.make_train_fns(JaxConfig(**kw, USE_PALLAS="off"), jg, 10, jplan).sampler_impl
    assert off.sampler_impl == jax_off.replace("xla", "torch")


def _clamping_chunk(n_pad):
    """A multiple of 8 that does not divide ``n_pad``: the final chunk clamps."""
    return next(c for c in (192, 160, 96) if n_pad % c and c < n_pad)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_scaled_pt_step_matches_jax(graphs, jax_capture, dtype):  # noqa: F811
    jg, jplan, tg, tplan = graphs
    chunk = _clamping_chunk(tplan.n_pad)
    cfg = dict(SMALL, SAMPLER="pt", GIBBS_SWEEPS=4, SAMPLER_MATMUL_DTYPE=dtype,
               SWEEP_BLOCK_SPARSE="on", SWEEP_BS_CHUNK=chunk, PERSISTENT_CHAINS=True)
    jfns = jstep.make_train_fns(JaxConfig(**cfg, USE_PALLAS="off"), jg, 100, jplan)
    assert jfns.sampler_impl == "xla" + ("+int8" if dtype == "int8" else "") + "+bs"
    imgs = _images(8, 3)
    state = jfns.init(jax.random.PRNGKey(6), jnp.asarray(imgs[:1]))
    feed = _step_feed(state, jplan, cfg, 8)
    tfns = make_train_fns(TrainingConfig(**cfg), tg, 100, tplan, device="cpu")
    assert tfns.sampler_impl == "cuda_hbm" + ("+int8" if dtype == "int8" else "") + "+bs"
    ts = train_state_from_jax(tfns, state)

    # the cache rebuilt from grbm_params is the JAX state's, bit for bit
    bsc = ts.sampler_coupling
    assert isinstance(bsc, BlockSparseCoupling) and bsc.chunk == chunk
    jp = np.asarray(state.sampler_coupling.panels.astype(jnp.float32))
    np.testing.assert_array_equal(bsc.panels.to(torch.float32).numpy(), jp)
    assert str(bsc.panels.dtype) == f"torch.{dtype}"
    if dtype == "int8":
        assert float(bsc.scale) == float(state.sampler_coupling.scale)

    new, m = jfns.step(state, jnp.asarray(imgs), jnp.asarray(0))
    feed.spin_uniforms = _t(jax_capture["u"])
    tm = tfns.step_body(ts, _t(imgs), 0, feed)
    for name, rtol in (("mse", 5e-5), ("dvae_loss", 5e-5), ("mmd", 1e-5), ("nll", 1e-5)):
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(m, name)),
                                   rtol=rtol, err_msg=name)
    np.testing.assert_allclose(ts.grbm_params.linear.numpy(), np.asarray(new.grbm_params.linear),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.grbm_params.quadratic.numpy(),
                               np.asarray(new.grbm_params.quadratic), rtol=0, atol=1e-6)
    same = (ts.chains.numpy() == np.asarray(new.chains)).all(axis=-1)
    assert same.mean() >= 0.98
    np.testing.assert_allclose(tm.pt_accept.numpy(), np.asarray(m.pt_accept), atol=1e-5)

    # an unscheduled step carries the ladder energies through K3's ΔE
    tfns.step_body(ts, _t(imgs), 6)
    e_rec = tgibbs.ising_energies(ts.sampler_h, ts.sampler_coupling, ts.chains)
    np.testing.assert_allclose(ts.chain_energies.numpy(), e_rec.numpy(), rtol=0,
                               atol=1e-5 * (1 + float(e_rec.abs().max())))


def test_trainer_trains_saves_and_serves_packed(tmp_path):
    """The slice end to end at a small size: ``Trainer`` under PT with a
    packed bf16 coupling (``cuda_hbm+bs``) trains an epoch with finite
    losses, carries its ladder energies, saves; ``WarmGenerator`` serves
    the saved model from a packed int8 coupling (``cuda_hbm+int8+bs``)."""
    from image_generation_tpu_torch.app.warm import WarmGenerator
    from image_generation_tpu_torch.training.trainer import Trainer

    cfg = TrainingConfig(**dict(SMALL, DATASET_SIZE=32, SAMPLER="pt", GIBBS_SWEEPS=4,
                                SAMPLER_MATMUL_DTYPE="bfloat16", SWEEP_BLOCK_SPARSE="on",
                                SWEEP_BS_CHUNK=192))
    t = Trainer(config=cfg, device="cpu")
    out = t.train(1)
    st = t.state
    assert t.fns.sampler_impl == "cuda_hbm+bs" and np.isfinite(out["final_dvae_loss"])
    assert isinstance(st.sampler_coupling, BlockSparseCoupling)
    assert st.sampler_coupling.panels.dtype == torch.bfloat16
    e_rec = tgibbs.ising_energies(st.sampler_h, st.sampler_coupling, st.chains)
    np.testing.assert_allclose(st.chain_energies.numpy(), e_rec.numpy(), rtol=0,
                               atol=1e-5 * (1 + float(e_rec.abs().max())))
    t.save(tmp_path / "m")
    w = WarmGenerator(tmp_path, device="cpu", config_overrides=dict(
        NUM_READS=8, GIBBS_BURN_IN=2, GIBBS_SWEEPS=2, SAMPLER_MATMUL_DTYPE="int8",
        SWEEP_BLOCK_SPARSE="on", SWEEP_BS_CHUNK=192))
    img = w.serve(tmp_path / "m")["images"]
    assert w._trainer.fns.sampler_impl == "cuda_hbm+int8+bs"
    assert img.shape == (8, 32, 32, 1) and np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0
