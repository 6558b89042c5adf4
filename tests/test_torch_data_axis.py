"""Port parity: the mesh's data axis and the chain-sharded sampler, on the CPU.

The port's ranks run as threads (``torch_ranks.run_ranks``: gloo groups
for every axis over one in-memory store) on (2, 2) and (4, 1) meshes; the
JAX side runs on its 8-device CPU mesh (tests/conftest.py) with the same
shape.  Inputs are made with numpy and handed to both.

Tolerances.  The chain-sharded sweep fed the same uniforms follows the
sweep rule of tests/test_torch_gibbs.py (at least 98 % of the chains
bit-identical; the two sides sum the fields in another order).  The
ladder split over ranks is bit-identical to the one-device ladder (the
same plain sweeps on the same rows, the swaps from the same energies).
The data-parallel step is held to the JAX package's own tolerances for
its sharded step (tests/test_sharding.py:106-130): MSE rtol 1e-4, loss
rtol 1e-3, fewer than 0.5 % of chain spins differing, parameters atol
5e-4; against the port's one-rank step on the same draws the same
bounds; across ranks the losses and the replicated parameters are equal
bit for bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_generation_tpu.config import TrainingConfig as JaxConfig
from image_generation_tpu.models import grbm as jgrbm
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.ops.gibbs_pallas import gibbs_sweeps_pallas_sharded
from image_generation_tpu.parallel import mesh as jmesh
from image_generation_tpu.training import step as jstep
from image_generation_tpu.utils import data as jdata
from image_generation_tpu.utils.subgraph import select_latent_graph
from image_generation_tpu.utils.topology import chimera_graph
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.io import native_ckpt
from image_generation_tpu_torch.models import grbm as tgrbm
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.parallel import dense as tdense
from image_generation_tpu_torch.parallel import mesh as tmesh
from image_generation_tpu_torch.training import step as tstep
from image_generation_tpu_torch.training.step import make_train_fns, train_state_from_jax
from image_generation_tpu_torch.training.trainer import Trainer
from image_generation_tpu_torch.utils import data as tdata
from test_torch_training import SMALL, _images, _step_feed, _t, graphs, jax_capture  # noqa: F401
from torch_ranks import run_ranks

MESHES = [(2, 2), (4, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(shape):
    return jmesh.create_mesh(shape[0] * shape[1], shape=shape)


# ---------------------------------------------------------------------------
# mesh shapes, batches
# ---------------------------------------------------------------------------

def test_mesh_shapes_and_batches_match_jax():
    """``default_shape`` is the JAX ``create_mesh`` default for every device
    count (odd ones too); ``shard_batch`` / ``shard_epoch_batches`` give
    each rank the rows JAX places on its device; ``chain_row_axes`` is the
    JAX ``shard_train_state`` rule."""
    for n in range(1, 9):
        assert tmesh.default_shape(n) == jmesh.create_mesh(n).devices.shape
    imgs = _images(8, 1)
    for shape in MESHES:
        jm = _jmesh(shape)
        sharded = jmesh.shard_batch(jnp.asarray(imgs), jm)
        epoch = jmesh.shard_epoch_batches(jnp.asarray(np.stack([imgs, imgs[::-1]])), jm)
        for d in range(shape[0]):
            for g in range(shape[1]):
                m = tmesh.Mesh(shape, data_index=d, graph_index=g, graph_group=object(),
                               data_group=object(), world_group=object())
                dev = jm.devices[d, g]
                want = [np.asarray(s.data) for s in sharded.addressable_shards if s.device == dev]
                np.testing.assert_array_equal(tmesh.shard_batch(_t(imgs), m).numpy(), want[0])
                want = [np.asarray(s.data) for s in epoch.addressable_shards if s.device == dev]
                got = tmesh.shard_epoch_batches(_t(np.stack([imgs, imgs[::-1]])), m)
                np.testing.assert_array_equal(got.numpy(), want[0])
        m = tmesh.Mesh(shape, graph_group=object(), data_group=object(), world_group=object())
        for rows, gs in ((16, False), (6, False), (3, False), (16, True), (3, True)):
            axes = tmesh.chain_row_axes(rows, m, gs)
            size = int(np.prod([shape[0] if a == "data" else shape[1] for a in axes]))
            assert rows % size == 0
            if not gs and rows % (shape[0] * shape[1]) == 0:
                assert size == shape[0] * shape[1]
    # a batch that does not tile the data axis stays whole (JAX replicates it)
    m = tmesh.Mesh((2, 1), data_group=object())
    assert tmesh.shard_batch(_t(imgs[:7]), m).shape[0] == 7


def test_epoch_batches_match_jax():
    """Batch counts and shapes as JAX ``epoch_batches`` with and without
    ``drop_last`` (the extra batch keeps its size, ending at the last
    image, as JAX's clamped slice does: the same positions of each side's
    permutation); with ``drop_last`` every image appears at most once and
    the batches are ``permuted_epoch``'s for the same generator state."""
    imgs = np.arange(10, dtype=np.float32).reshape(10, 1, 1, 1)
    for drop in (True, False):
        ours = list(tdata.epoch_batches(_t(imgs), 3, torch.Generator().manual_seed(0), drop))
        theirs = list(jdata.epoch_batches(jnp.asarray(imgs), 3, jax.random.PRNGKey(0), drop))
        assert [b.shape for b in ours] == [tuple(b.shape) for b in theirs]
        perm_j = np.concatenate([np.asarray(b).ravel() for b in theirs[:3]] + [
            np.setdiff1d(imgs.ravel(), np.concatenate([np.asarray(b).ravel() for b in theirs[:3]]))])
        perm_t = torch.cat(ours[:3]).ravel().numpy()
        perm_t = np.concatenate([perm_t, np.setdiff1d(imgs.ravel(), perm_t)])
        if not drop:  # the last batch: positions 7..9 of each permutation
            np.testing.assert_array_equal(np.asarray(theirs[3]).ravel(), perm_j[7:])
            np.testing.assert_array_equal(ours[3].ravel().numpy(), perm_t[7:])
        seen = torch.cat(ours[:3]).flatten()
        assert len(set(seen.tolist())) == seen.numel()
    stacked = tdata.permuted_epoch(_t(imgs), 3, torch.Generator().manual_seed(0))
    for a, b in zip(tdata.epoch_batches(_t(imgs), 3, torch.Generator().manual_seed(0)), stacked):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the chain-sharded sweep and the ladder over ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_model():
    """The JAX sharded-kernel tests' 12-spin Chimera subgraph, a random
    model on it, 64 chains, 4 sweeps of fed uniforms."""
    g, _ = select_latent_graph(chimera_graph(2, 2, 3), 12, 11)
    jg = jgrbm.GRBMGraph.from_networkx(g)
    tg = tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j)
    rng = np.random.RandomState(1)
    h = rng.uniform(-0.3, 0.3, jg.n).astype(np.float32)
    j = rng.uniform(-0.5, 0.5, jg.n_edges).astype(np.float32)
    jplan = jgibbs.build_plan(jg, pad_to=128)
    tplan = tgibbs.build_plan(tg, pad_to=128)
    hp, cp = jgibbs.permuted_model(jplan, jnp.asarray(h), jnp.asarray(j))
    key = jax.random.PRNGKey(3)
    s0 = np.asarray(jgibbs.random_spins(key, jplan, 64))
    u = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (4, 64, jplan.n_pad)))
    return jg, jplan, tg, tplan, np.asarray(hp), np.asarray(cp), s0, u


@pytest.mark.parametrize("shape", MESHES)
def test_chain_sharded_sweep_matches_jax(small_model, shape):
    """The port's sweep on each rank's rows (the K1 wrapper's plain
    version here), fed the global uniforms, against JAX
    ``gibbs_sweeps_pallas_sharded`` in interpret mode on the same mesh; with
    ΔE at per-chain β too.  Without uniforms each rank draws its own
    stream (its Philox seed folded with its slice)."""
    jg, jplan, tg, tplan, hp, cp, s0, u = small_model
    beta = np.linspace(0.5, 1.5, 64).astype(np.float32)
    jm = _jmesh(shape)
    ref = np.asarray(gibbs_sweeps_pallas_sharded(
        jax.random.PRNGKey(0), jnp.asarray(hp), jnp.asarray(cp), jplan, jnp.asarray(s0), 4, jm,
        interpret=True, uniforms=jnp.asarray(u), chain_block=8))
    ref_b, ref_de = (np.asarray(x) for x in gibbs_sweeps_pallas_sharded(
        jax.random.PRNGKey(0), jnp.asarray(hp), jnp.asarray(cp), jplan, jnp.asarray(s0), 4, jm,
        jnp.asarray(beta), interpret=True, uniforms=jnp.asarray(u), chain_block=8,
        track_delta_e=True))
    cfg = TrainingConfig(N_LATENTS=12, NUM_READS=64, SAMPLER_MATMUL_DTYPE="float32")

    def rank(mesh):
        fns = make_train_fns(cfg, tg, 10, tplan, device="cpu", mesh=mesh)
        rows = fns.row_shard(64)
        loc = fns.local(_t(s0), rows)
        lo = rows.index * loc.shape[0]
        a = fns.sweeps_fn(None, _t(hp), _t(cp), loc, 4, uniforms=_t(u), rows=rows)
        b, de = fns.sweeps_fn(None, _t(hp), _t(cp), loc, 4, _t(beta[lo:lo + loc.shape[0]]),
                              uniforms=_t(u), track_delta_e=True, rows=rows)
        g = torch.Generator().manual_seed(5)
        c = fns.sweeps_fn(g, _t(hp), _t(cp), torch.ones_like(loc), 4, rows=rows)
        return fns.sampler_impl, rows, a, b, de, c

    outs = run_ranks(shape[0] * shape[1], rank, shape)
    assert {o[0] for o in outs} == {"cuda_vmem_sharded"}
    assert all(o[1].n == 4 and o[1].index == r for r, o in enumerate(outs))
    a = torch.cat([o[2] for o in outs]).numpy()
    b = torch.cat([o[3] for o in outs]).numpy()
    de = torch.cat([o[4] for o in outs]).numpy()
    assert (a == ref).all(axis=1).mean() >= 0.98
    same = (b == ref_b).all(axis=1)
    assert same.mean() >= 0.98
    np.testing.assert_allclose(de[same], ref_de[same], rtol=1e-5, atol=1e-5)
    c = [o[5].numpy() for o in outs]
    assert not np.array_equal(c[0], c[1])  # the ranks' streams differ


@pytest.mark.parametrize("shape", MESHES)
def test_untiled_chains_sweep_through_the_kernel(small_model, shape, monkeypatch):
    """18 chains on 4 ranks, which JAX sends to its XLA sweep: the build
    names the route ``torch`` as JAX names it ``xla``, and every call
    still goes through a kernel's wrapper on each rank's rows
    (``gibbs_sweeps_cuda``, or ``gibbs_sweeps_hbm_cuda(round_up=False)``
    for packed panels), at exactly the 3 sweeps asked for, never through
    the plain sweep.  Fed the global uniforms, the ranks' rows follow the
    one-device plain sweep under the sweep rule (at least 98 % of the
    chains bit-identical), dense and packed."""
    from image_generation_tpu_torch.ops.block_sparse import pack_coupling
    from image_generation_tpu_torch.training import step as tstep

    _jg, _jplan, tg, tplan, hp, cp, s0, u = small_model
    n, sweeps = 18, 3
    s18, u18 = _t(s0[:n]), _t(u[:sweeps, :n])
    ref = tgibbs.gibbs_sweeps_reference(_t(hp), _t(cp), tplan, s18, sweeps,
                                        uniforms=u18).numpy()
    calls = []

    def plain(*_a, **_k):
        raise AssertionError("the plain sweep ran on a mesh whose chains do not tile it")

    def counted(name, fn):
        def wrapper(hp_, coupling, plan, spins, n_sweeps, *a, **kw):
            calls.append((name, int(spins.shape[0]), n_sweeps, kw.get("round_up", True)))
            return fn(hp_, coupling, plan, spins, n_sweeps, *a, **kw)
        return wrapper

    monkeypatch.setattr(tstep, "gibbs_sweeps_reference", plain)
    monkeypatch.setattr(tstep, "gibbs_sweeps_cuda", counted("K1", tstep.gibbs_sweeps_cuda))
    monkeypatch.setattr(tstep, "gibbs_sweeps_hbm_cuda",
                        counted("K3", tstep.gibbs_sweeps_hbm_cuda))
    cfg = TrainingConfig(N_LATENTS=12, NUM_READS=n, SAMPLER_MATMUL_DTYPE="float32")

    def rank(mesh):
        fns = make_train_fns(cfg, tg, 10, tplan, device="cpu", mesh=mesh)
        rows = fns.row_shard(n)
        loc = fns.local(s18, rows)
        lo = rows.index * loc.shape[0]
        out = [fns.sweeps_fn(None, _t(hp), c, loc, sweeps, uniforms=u18, rows=rows)
               for c in (_t(cp), pack_coupling(tplan, _t(cp), 32))]
        return fns.sampler_impl, lo, out

    outs = run_ranks(shape[0] * shape[1], rank, shape)
    per_rank = n // shape[0] if shape == (2, 2) else n
    assert {o[0] for o in outs} == {"torch"}
    assert sorted(set(calls)) == [("K1", per_rank, sweeps, True), ("K3", per_rank, sweeps, False)]
    assert len(calls) == 2 * len(outs)
    for k in range(2):
        got = np.concatenate([o[2][k].numpy() for o in outs])
        want = np.concatenate([ref[o[1]:o[1] + per_rank] for o in outs])
        assert (got == want).all(axis=1).mean() >= 0.98


@pytest.mark.parametrize("shape", MESHES)
def test_ladder_split_over_ranks_equals_one_device(small_model, shape):
    """``pt_round`` with an 8-rung ladder split over the mesh (two rungs a
    rank), fed sweep and swap uniforms: spins, energies and the swap
    acceptance equal the one-device round bit for bit, and ``LadderShard``
    hands every rank the β = 1 rung; with carried energies too."""
    _jg, _jplan, _tg, tplan, hp, cp, _s0, _u = small_model
    t_dim, c = 8, 6
    rng = np.random.default_rng(2)
    betas = _t(np.linspace(0.2, 1.0, t_dim).astype(np.float32))
    ladder0 = _t(rng.choice([-1.0, 1.0], (t_dim, c, tplan.n_pad)).astype(np.float32))
    u = _t(rng.random((3, t_dim * c, tplan.n_pad)).astype(np.float32))
    swaps = tuple(_t(rng.random((t_dim - 1, c)).astype(np.float32)) for _ in range(2))
    one = tgibbs.pt_round(None, _t(hp), _t(cp), tplan, ladder0, betas, 3, uniforms=u,
                          swap_uniforms=swaps, return_accept=True)
    e0 = tgibbs.ising_energies(_t(hp), _t(cp), ladder0)
    one_e = tgibbs.pt_round(None, _t(hp), _t(cp), tplan, ladder0, betas, 3, uniforms=u,
                            swap_uniforms=swaps, return_accept=True, energies=e0)

    def rank(mesh):
        lad = tmesh.LadderShard(mesh, ("data", "graph") if min(shape) > 1 else
                                ("data",) if shape[1] == 1 else ("graph",), t_dim)
        sl = slice(lad.t0, lad.t1)
        rows = slice(lad.t0 * c, lad.t1 * c)
        out = tgibbs.pt_round(None, _t(hp), _t(cp), tplan, ladder0[sl].clone(), betas, 3,
                              uniforms=u[:, rows].contiguous(), swap_uniforms=swaps,
                              return_accept=True, ladder=lad)
        out_e = tgibbs.pt_round(None, _t(hp), _t(cp), tplan, ladder0[sl].clone(), betas, 3,
                                uniforms=u[:, rows].contiguous(), swap_uniforms=swaps,
                                return_accept=True, energies=e0[sl], ladder=lad)
        return out, out_e, lad.target(out[0])

    outs = run_ranks(shape[0] * shape[1], rank, shape)
    for k, ref in enumerate((one, one_e)):
        np.testing.assert_array_equal(torch.cat([o[k][0] for o in outs]).numpy(), ref[0].numpy())
        np.testing.assert_array_equal(torch.cat([o[k][1] for o in outs]).numpy(), ref[1].numpy())
        for o in outs:
            np.testing.assert_array_equal(o[k][2].numpy(), ref[2].numpy())
    for o in outs:
        np.testing.assert_array_equal(o[2].numpy(), one[0][-1].numpy())


@pytest.mark.parametrize("pt", [False, True], ids=["gibbs", "pt"])
@pytest.mark.parametrize("shape", MESHES)
def test_dispatch_on_a_mesh_matches_jax(graphs, shape, pt):  # noqa: F811
    """``sampler_impl`` against JAX ``make_train_fns(mesh=…)``, ``pallas``
    spelled ``cuda`` and ``xla`` ``torch``: chains that tile the mesh keep
    the kernel (``_sharded``), 18 chains on 4 ranks drop to the plain
    route (under PT the 4 × 18 ladder rows tile it)."""
    jg, jplan, tg, tplan = graphs
    m = tmesh.Mesh(shape, graph_group=object(), data_group=object(), world_group=object())
    for reads in (16, 18):
        for pallas in ("on", "off"):
            kw = dict(SMALL, NUM_READS=reads, SAMPLER="pt" if pt else "gibbs", PT_NUM_BETAS=4,
                      USE_PALLAS=pallas)
            jfns = jstep.make_train_fns(JaxConfig(**kw), jg, 10, jplan, mesh=_jmesh(shape))
            fns = make_train_fns(TrainingConfig(**kw), tg, 10, tplan, device="cpu", mesh=m)
            assert fns.sampler_impl == jfns.sampler_impl.replace("pallas", "cuda").replace(
                "xla", "torch"), (reads, pallas)


# ---------------------------------------------------------------------------
# the data-parallel step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps(graphs, jax_capture):  # noqa: F811
    """The JAX step on one device and on each mesh (GSPMD from the input
    shardings, USE_PALLAS off on the CPU), plain Gibbs and 4-rung PT,
    from one state each; with the port's feed of the one-device draws."""
    jg, jplan, _tg, _tplan = graphs
    out = {}
    imgs = _images(8, 3)
    for sampler in ("gibbs", "pt"):
        cfg = dict(SMALL, SAMPLER=sampler, PT_NUM_BETAS=4, PERSISTENT_CHAINS=True,
                   SAMPLER_MATMUL_DTYPE="float32")
        jfns = jstep.make_train_fns(JaxConfig(**cfg), jg, 100, jplan)
        state = jax.jit(jfns.init)(jax.random.PRNGKey(11), jnp.asarray(imgs[:1]))
        feed = _step_feed(state, jplan, cfg, 8)
        single = jfns.step(state, jnp.asarray(imgs), jnp.asarray(0))
        feed.spin_uniforms = _t(jax_capture["u"])
        sharded = {}
        for shape in MESHES:
            jm = _jmesh(shape)
            st = jmesh.shard_train_state(jax.tree.map(jnp.array, state), jm)
            sharded[shape] = jfns.step(st, jmesh.shard_batch(jnp.asarray(imgs), jm),
                                       jnp.asarray(0))
        out[sampler] = (cfg, state, feed, single, sharded, imgs)
    return out


def _port_step(cfg, graphs, state, feed, imgs, mesh):  # noqa: F811
    _jg, _jplan, tg, tplan = graphs
    fns = make_train_fns(TrainingConfig(**cfg), tg, 100, tplan, device="cpu", mesh=mesh)
    ts = train_state_from_jax(fns, state)
    m = fns.step_body(ts, _t(imgs), 0, feed)
    return fns, ts, m


@pytest.mark.parametrize("sampler", ["gibbs", "pt"])
@pytest.mark.parametrize("shape", MESHES)
def test_data_parallel_step_matches_jax(graphs, jax_steps, shape, sampler):  # noqa: F811
    """One scheduled step (both negative phases and the GRBM update) on
    the mesh, each rank on its slice of the batch and its rows of the
    chains, fed the one-device draws: against JAX's sharded step and the
    port's one-rank step, and equal on every rank."""
    cfg, state, feed, (jnew, jm1), sharded, imgs = jax_steps[sampler]
    jnew2, jm2 = sharded[shape]
    _fns1, ts1, tm1 = _port_step(cfg, graphs, state, feed, imgs, None)

    def rank(mesh):
        fns, ts, m = _port_step(cfg, graphs, state, feed, imgs, mesh)
        return fns.sampler_impl, fns.train_rows, ts, m

    outs = run_ranks(shape[0] * shape[1], rank, shape)
    assert outs[0][0] == jstep.make_train_fns(
        JaxConfig(**cfg, USE_PALLAS="on"), graphs[0], 100, graphs[1],
        mesh=_jmesh(shape)).sampler_impl.replace("pallas", "cuda")
    rows = outs[0][1]
    assert rows.n == 4 and [o[1].index for o in outs] == [0, 1, 2, 3]
    ts0, tm0 = outs[0][2], outs[0][3]
    for ref in (jm2, jm1, tm1):
        np.testing.assert_allclose(float(tm0.mse), float(ref.mse), rtol=1e-4)
        np.testing.assert_allclose(float(tm0.dvae_loss), float(ref.dvae_loss), rtol=1e-3)
    np.testing.assert_allclose(float(tm0.nll), float(jm2.nll), rtol=1e-3)
    chains = torch.cat([o[2].chains for o in outs]).numpy()
    for ref in (np.asarray(jnew2.chains), np.asarray(jnew.chains), ts1.chains.numpy()):
        assert np.mean(chains != ref) < 0.005
    w = ts0.dvae.state_dict()["_encoder.conv.0.weight"].numpy()
    for ref in (np.asarray(jnew2.dvae_params["encoder"]["conv_0"]["kernel"]).transpose(3, 2, 0, 1),
                ts1.dvae.state_dict()["_encoder.conv.0.weight"].numpy()):
        np.testing.assert_allclose(w, ref, atol=5e-4)
    for _impl, _rows, ts, m in outs[1:]:
        for f in ("mse", "mmd", "dvae_loss", "nll"):
            assert float(getattr(m, f)) == float(getattr(tm0, f)), f
        np.testing.assert_array_equal(m.pt_accept.numpy(), tm0.pt_accept.numpy())
        for k, v in ts.dvae.state_dict().items():
            assert torch.equal(v, ts0.dvae.state_dict()[k]), k
        assert torch.equal(ts.grbm_params.linear, ts0.grbm_params.linear)
        assert torch.equal(ts.grbm_params.quadratic, ts0.grbm_params.quadratic)


def test_trainer_on_a_data_axis_mesh(tmp_path):
    """``Trainer(mesh=…)`` on (2, 2) ranks, plain Gibbs and PT: an epoch of
    data-sharded steps with the losses and parameters equal on every rank,
    ``save`` on rank 0, ``sample_spins`` equal on every rank, with a
    ``num_reads`` that does not tile the mesh too, and an epoch of 6
    chains, which do not tile it (``torch`` as JAX's ``xla``; the kernel's
    wrapper on each data row's 3 chains); ``save_native`` on the mesh writes
    the global state (the whole chains); ``shard_train_state`` with
    ``dense_min_elems=4096`` cuts a whole one-process state to this rank's
    chains and column-shards its dense layer with its moments; on one rank
    ``mesh="auto"`` is no mesh."""
    base = dict(N_LATENTS=32, NUM_READS=8, BATCH_SIZE=8, DATASET_SIZE=16, N_REPLICAS=2,
                GIBBS_SWEEPS=2, GIBBS_BURN_IN=2, QPU="Advantage2_prototype",
                COMPUTE_DTYPE="float32")

    def rank(mesh):
        res = []
        for kw in (dict(SAMPLER="gibbs"), dict(SAMPLER="pt", PT_NUM_BETAS=4),
                   dict(SAMPLER="gibbs", NUM_READS=6)):
            t = Trainer(TrainingConfig(**{**base, **kw}), device="cpu", mesh=mesh)
            t.train_init(1)
            stats = t.train_epoch(0)
            if kw["SAMPLER"] == "gibbs":  # 8 chains over all 4 ranks, 6 over the data axis
                assert t.state.chains.shape[0] == (3 if kw.get("NUM_READS") == 6 else 2)
            res.append((t.fns.sampler_impl, stats, t.sample_spins(8, 2), t.sample_spins(10, 2),
                        {k: v.clone() for k, v in t.dvae.state_dict().items()},
                        t.grbm_params.linear.detach().clone()))
        path = t.save(tmp_path / "m")
        native = t.save_native(tmp_path / "ckpt")
        assert native_ckpt.load_payload(tmp_path / "ckpt")["chains"].shape[0] == 6
        # a whole one-process state, one step in (so Adam has moments), cut
        # to this rank's part with the dense layer sharded
        fns1 = make_train_fns(t.config, t.graph, 10, t.plan, device="cpu")
        whole = fns1.init(5)
        fns1.step_body(whole, t.images[:8], 0)
        w, mu = (whole.dvae._decoder.increase_latent_dim.weight.detach().clone(),
                 whole.dvae_opt.state[whole.dvae._decoder.increase_latent_dim.weight][
                     "exp_avg"].clone())
        chains = whole.chains.clone()
        st = tmesh.shard_train_state(whole, mesh, dense_min_elems=4096)
        layer = st.dvae._decoder.increase_latent_dim
        lo = mesh.rank * 32
        assert isinstance(layer, tdense.ColumnShardedLinear)
        assert torch.equal(layer.weight, w[lo:lo + 32])
        assert torch.equal(st.dvae_opt.state[layer.weight]["exp_avg"], mu[lo:lo + 32])
        assert torch.equal(st.chains, chains[3 * mesh.data_index:3 * mesh.data_index + 3])
        return res, path, native

    outs = run_ranks(4, rank, (2, 2))
    for (res, path, native) in outs:
        for k, (impl, stats, s8, s10, sd, lin) in enumerate(res):
            ref = outs[0][0][k]
            assert impl == ("torch" if k == 2 else "cuda_vmem_sharded")
            assert np.isfinite(stats["mse"]) and stats["mse"] == ref[1]["mse"]
            assert s8.shape == (8, 32) and torch.equal(s8, ref[2])
            assert s10.shape == (10, 32) and torch.equal(s10, ref[3])
            assert set(torch.unique(s10).tolist()) <= {-1.0, 1.0}
            for name, v in sd.items():
                assert torch.equal(v, ref[4][name]), name
            assert torch.equal(lin, ref[5])
        assert path == tmp_path / "m" and native == tmp_path / "ckpt" / "step_00000002.pt"
    assert sorted(p.name for p in (tmp_path / "m").iterdir()) == [
        "dvae.pth", "grbm.pth", "losses.json", "parameters.json"]
    assert Trainer(TrainingConfig(**base), device="cpu").mesh is None


@pytest.mark.parametrize("sampler", ["gibbs", "pt"])
def test_graph_sharded_trainer_with_a_data_axis(sampler):
    """``GRAPH_SHARDED="on"`` on (2, 2) ranks, the JAX layout: the graph
    axis splits the coupling and the chain columns, the data axis the
    chain rows (the PT ladder's rungs) and the batch; an epoch and
    ``sample_spins`` agree on every rank."""
    cfg = TrainingConfig(N_LATENTS=32, NUM_READS=8, BATCH_SIZE=8, DATASET_SIZE=16, N_REPLICAS=2,
                         GIBBS_SWEEPS=2, GIBBS_BURN_IN=2, QPU="Advantage2_prototype",
                         SAMPLER=sampler, PT_NUM_BETAS=2, GRAPH_SHARDED="on",
                         COMPUTE_DTYPE="float32")

    def rank(mesh):
        t = Trainer(cfg, device="cpu", mesh=mesh)
        t.train_init(1)
        stats = t.train_epoch(0)
        return (t.fns.sampler_impl, t.fns.train_rows, stats["mse"], t.sample_spins(6, 2),
                tuple(t.state.chains.shape), t.state.sampler_coupling.shape)

    outs = run_ranks(4, rank, (2, 2))
    n_pad = outs[0][5][1]
    for r, (impl, rows, mse, spins, chains, coupling) in enumerate(outs):
        assert impl == "torch_graph_sharded+plrng" and rows.axes == ("data",)
        assert rows.index == r // 2 and coupling == (n_pad // 2, n_pad)
        assert chains == ((4, n_pad // 2) if sampler == "gibbs" else (1, 8, n_pad // 2))
        assert np.isfinite(mse) and mse == outs[0][2]
        assert spins.shape == (6, 32) and torch.equal(spins, outs[0][3])


# ---------------------------------------------------------------------------
# native checkpoints and the auto ladder on a mesh
# ---------------------------------------------------------------------------

NATIVE = dict(N_LATENTS=32, NUM_READS=8, BATCH_SIZE=8, DATASET_SIZE=16, N_REPLICAS=2,
              GIBBS_SWEEPS=2, GIBBS_BURN_IN=2, QPU="Advantage2_prototype",
              COMPUTE_DTYPE="float32", SAMPLER="pt", PT_NUM_BETAS=4, ADAM_FACTORED_NU="on")


def _payloads_equal(a: dict, b: dict) -> None:
    """Two checkpoint dicts hold the same state, bit for bit."""
    assert a.keys() == b.keys()
    for k in a["dvae"]:
        assert torch.equal(a["dvae"][k], b["dvae"][k]), k
    for opt in ("dvae_opt", "grbm_opt"):
        sa, sb = a[opt]["state"], b[opt]["state"]
        assert sa.keys() == sb.keys()
        for i in sa:
            assert sa[i].keys() == sb[i].keys()
            for k in sa[i]:
                assert torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k])), (opt, k)
    for k in ("grbm_linear", "grbm_quadratic", "chains", "chain_energies", "pt_betas",
              "generator"):
        assert torch.equal(a[k], b[k]), k
    assert a["opt_step"] == b["opt_step"] and a["extra"] == b["extra"]


def test_native_checkpoints_across_topologies(tmp_path, monkeypatch):
    """A 4-rung PT run with the dense layer column-sharded and a factored ν
    saved on (2, 2) after one epoch: the file is the global state in the
    one-device schema (the whole layer and its μ / ν factors, the whole
    ladder); resumed on (4, 1) and on one device the gathered global state
    equals the file bit for bit; resumed on (2, 2) and trained on, it
    equals the uninterrupted run."""
    monkeypatch.setattr(tstep, "DENSE_MIN_ELEMS", 4096)
    monkeypatch.setattr(tstep, "_FACTORED_NU_MIN", 4096)
    cfg = TrainingConfig(**NATIVE)
    ck = tmp_path / "ck"

    def uninterrupted(mesh):
        t = Trainer(cfg, device="cpu", mesh=mesh)
        t.train_init(2)
        t.train_epoch(0)
        t.save_native(ck)
        t.train_epoch(1)
        return native_ckpt.global_payload(t.state, t.fns), t.losses

    def resumed(mesh):
        t = Trainer(cfg, device="cpu", mesh=mesh)
        assert t.resume_native(ck, n_epochs=2) == 2
        # a copy: the payload's tensors are the live state's, which training moves
        restored = copy.deepcopy(native_ckpt.global_payload(
            t.state, t.fns, {"seed_stream": t._seeds.bit_generator.state}))
        ran = []
        t.train(2, epoch_cb=lambda e, _s: ran.append(e))
        assert ran == [1]
        return restored, native_ckpt.global_payload(t.state, t.fns), t.losses

    full = run_ranks(4, uninterrupted, (2, 2))
    saved = native_ckpt.load_payload(ck)
    layer = saved["dvae"]["_decoder.increase_latent_dim.weight"]
    assert layer.shape == (128, 32) and saved["chains"].shape[:2] == (4, 8)
    fac = [v for v in saved["dvae_opt"]["state"].values() if "nu_col" in v]
    assert len(fac) == 1  # the one 2-D leaf of 4,096 elements and more
    fac = fac[0]
    assert fac["exp_avg"].shape == (128, 32) and fac["nu_col"].shape == (128,)
    assert fac["nu_row"].shape == (32,) and "exp_avg_sq" not in fac
    for shape in ((4, 1), None):
        if shape is None:
            outs = [resumed(None)]
        else:
            outs = run_ranks(4, resumed, shape)
        for restored, _after, _losses in outs:
            _payloads_equal(restored, saved)
    again = run_ranks(4, resumed, (2, 2))
    for (want, losses), (_restored, got, got_losses) in zip(full, again):
        _payloads_equal(got, want)
        assert got_losses == losses


def test_auto_ladder_on_a_mesh_matches_jax():
    """``PT_NUM_BETAS="auto"`` on (2, 2) ranks: every rank probes alike and
    freezes the same ladder, and trains with it; for the same model the
    probe on the mesh (rank 0's) gives JAX's trainer on a (2, 2) CPU mesh
    its ``num_betas``."""
    from image_generation_tpu.config import TrainingConfig as JaxConfig
    from image_generation_tpu.training import trainer as jtrainer

    kw = dict(N_LATENTS=32, NUM_READS=8, BATCH_SIZE=8, DATASET_SIZE=16, N_REPLICAS=2,
              GIBBS_SWEEPS=2, GIBBS_BURN_IN=2, QPU="Advantage2_prototype",
              COMPUTE_DTYPE="float32", SAMPLER="pt", PT_NUM_BETAS="auto")
    jt = jtrainer.Trainer(config=JaxConfig(**kw), mesh=_jmesh((2, 2)))
    jt.setup()
    # couplings of 2: a probe barrier near 0.68, 3 rungs (T = ⌈Λ / 0.5⌉ + 1)
    model = jt.graph.init_params(jax.random.PRNGKey(4), scale=2.0)
    jt._resolve_auto_ladder(model)

    def rank(mesh):
        t = Trainer(TrainingConfig(**kw), device="cpu", mesh=mesh)
        t.train_init(1)
        trained = (t.config.PT_BETAS, t.pt_auto_info["num_betas"], t.train_epoch(0)["mse"])
        if mesh.rank:
            return trained, None
        probe = Trainer(TrainingConfig(**kw), device="cpu", mesh=mesh)
        probe.setup()
        probe._resolve_auto_ladder(tgrbm.GRBMParams(_t(model.linear), _t(model.quadratic)))
        return trained, probe.pt_auto_info

    outs = run_ranks(4, rank, (2, 2))
    (betas0, n0, mse0), info0 = outs[0]
    assert n0 == len(betas0) and np.isfinite(mse0)
    for (betas, n, mse), _info in outs:
        assert betas == betas0 and n == n0 and mse == mse0
    assert info0["num_betas"] == jt.pt_auto_info["num_betas"] > 2
