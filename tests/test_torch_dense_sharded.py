"""Port parity: the column-sharded dense layer, on the CPU.

The port's ranks run as threads (``torch_ranks.run_ranks``) on (2, 2) and
(4, 1) meshes, and on a (1, 2) graph-sharded one; the JAX side runs on
its 8-device CPU mesh (tests/conftest.py) with the same shape.  The model
is the 32-latent prototype in f32 with ``dense_min_elems=4096``, so the
decoder's Linear(32 → 128) is the sharded layer, as the scaled config's
Linear(5640 → 22560) is at the default size.

Tolerances.  The data-parallel step with the sharded layer is held to the
JAX package's tolerances for its sharded step (tests/test_sharding.py:
106-130; tests/test_torch_data_axis.py): MSE rtol 1e-4, loss rtol 1e-3;
the updated layer gathered whole, and its Adam μ and ν, within 5e-4 of
JAX's (the parameters' bound there), against JAX ``shard_train_state(...,
dense_min_elems=kernel.size)`` and against the port's one-process step;
across ranks the losses and the replicated parameters are bit-equal.
The moment levers on a sharded weight follow tests/test_torch_optim.py:
updates within 1e-6 relative or two ulps of the parameter, f32 states
and the factors within 1e-6 relative, bf16 moments within one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from image_generation_tpu.config import TrainingConfig as JaxConfig
from image_generation_tpu.parallel import mesh as jmesh
from image_generation_tpu.training import step as jstep
from image_generation_tpu.training.optim import scale_by_adam_moments
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.io.torch_pth import load_state_dict
from image_generation_tpu_torch.parallel import dense as tdense
from image_generation_tpu_torch.parallel import mesh as tmesh
from image_generation_tpu_torch.training import step as tstep
from image_generation_tpu_torch.training.optim import AdamMoments
from image_generation_tpu_torch.training.step import make_train_fns, train_state_from_jax
from image_generation_tpu_torch.training.trainer import Trainer
from test_torch_optim import _bf16_ulp_close
from test_torch_training import SMALL, _images, _step_feed, _t, graphs, jax_capture  # noqa: F401
from torch_ranks import run_ranks

MESHES = [(2, 2), (4, 1)]
MIN_ELEMS = 4096  # Linear(32 -> 128): the sharded layer
LAYER = "_decoder.increase_latent_dim"
CFG = dict(SMALL, SAMPLER="gibbs", PERSISTENT_CHAINS=True, SAMPLER_MATMUL_DTYPE="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(shape):
    return jmesh.create_mesh(shape[0] * shape[1], shape=shape)


def _jax_moments(opt_state, shape):
    """(μ, ν) of the leaf of ``shape`` in a JAX ``dvae_opt`` state (the
    Adam state's mu tree comes before its nu tree)."""
    leaves = [np.asarray(x) for x in jax.tree.leaves(opt_state)
              if getattr(x, "shape", None) == shape]
    return leaves[0], leaves[1]


@pytest.fixture(scope="module")
def jax_dense(graphs, jax_capture):  # noqa: F811
    """The JAX step from one state on one device and on each mesh with the
    decoder's dense kernel column-sharded, and the port's feed of the
    one-device draws."""
    jg, jplan, _tg, _tplan = graphs
    imgs = _images(8, 3)
    jfns = jstep.make_train_fns(JaxConfig(**CFG), jg, 100, jplan)
    state = jax.jit(jfns.init)(jax.random.PRNGKey(11), jnp.asarray(imgs[:1]))
    kernel = state.dvae_params["decoder"]["increase_latent_dim"]["kernel"]
    assert kernel.size == MIN_ELEMS
    feed = _step_feed(state, jplan, CFG, 8)
    single = jfns.step(state, jnp.asarray(imgs), jnp.asarray(0))
    feed.spin_uniforms = _t(jax_capture["u"])
    sharded = {}
    for shape in MESHES:
        jm = _jmesh(shape)
        st = jmesh.shard_train_state(jax.tree.map(jnp.array, state), jm,
                                     dense_min_elems=kernel.size)
        assert st.dvae_params["decoder"]["increase_latent_dim"]["kernel"].sharding.spec == \
            jmesh.P(None, ("data", "chain"))
        new, m = jfns.step(st, jmesh.shard_batch(jnp.asarray(imgs), jm), jnp.asarray(0))
        k = np.asarray(new.dvae_params["decoder"]["increase_latent_dim"]["kernel"])
        sharded[shape] = (m, k.T, *(x.T for x in _jax_moments(new.dvae_opt, kernel.shape)))
    return state, feed, single, sharded, imgs


def _rank_step(graphs, state, feed, imgs, mesh, cfg=CFG):  # noqa: F811
    """One fed step of the port on ``mesh`` (None: one process) with the
    layer sharded at ``MIN_ELEMS``; returns what the checks read, the
    sharded layer and its moments gathered whole."""
    _jg, _jplan, tg, tplan = graphs
    fns = make_train_fns(TrainingConfig(**cfg), tg, 100, tplan, device="cpu", mesh=mesh,
                         dense_min_elems=MIN_ELEMS)
    ts = train_state_from_jax(fns, state)
    layer = ts.dvae._decoder.increase_latent_dim
    w0 = layer.weight.detach().clone()
    m = fns.step_body(ts, _t(imgs), 0, feed)
    sd = tdense.gather_large_dense(ts.dvae)
    opt = tdense.gather_optimizer_state(ts.dvae_opt)
    i = [p is layer.weight for g in ts.dvae_opt.param_groups for p in g["params"]].index(True)
    return dict(kind=type(layer).__name__, w0=w0, m=m, sd=sd, mu=opt["state"][i]["exp_avg"],
                nu=opt["state"][i]["exp_avg_sq"], local_mu=ts.dvae_opt.state[layer.weight][
                    "exp_avg"].shape, grad_rows=layer.weight.shape[0], ts=ts)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_layer_step_matches_jax(graphs, jax_dense, shape):  # noqa: F811
    """Placement and one fed data-parallel step with the sharded layer:
    rank k holds rows [k·32, (k+1)·32) of the whole weight and of its
    moments; the step against JAX's sharded step and the port's
    one-process step; losses and replicated parameters equal on every
    rank, the gathered layer the same on every rank."""
    state, feed, (jnew, jm1), sharded, imgs = jax_dense
    jm2, jk, jmu, jnu = sharded[shape]
    one = _rank_step(graphs, state, feed, imgs, None)
    assert one["kind"] == "Linear"
    outs = run_ranks(4, lambda mesh: _rank_step(graphs, state, feed, imgs, mesh), shape)
    whole0 = torch.tensor(np.asarray(state.dvae_params["decoder"]["increase_latent_dim"]
                                     ["kernel"]).T)
    r0 = outs[0]
    for r, o in enumerate(outs):
        assert o["kind"] == "ColumnShardedLinear" and o["grad_rows"] == 32
        assert o["local_mu"] == (32, 32)
        assert torch.equal(o["w0"], whole0[r * 32:(r + 1) * 32])
        for f in ("mse", "mmd", "dvae_loss", "nll"):
            assert float(getattr(o["m"], f)) == float(getattr(r0["m"], f)), f
        for k, v in o["sd"].items():
            assert torch.equal(v, r0["sd"][k]), k
        assert torch.equal(o["mu"], r0["mu"]) and torch.equal(o["nu"], r0["nu"])
    assert r0["sd"][f"{LAYER}.weight"].shape == (128, 32)
    for ref in (jm2, jm1, one["m"]):
        np.testing.assert_allclose(float(r0["m"].mse), float(ref.mse), rtol=1e-4)
        np.testing.assert_allclose(float(r0["m"].dvae_loss), float(ref.dvae_loss), rtol=1e-3)
    np.testing.assert_allclose(r0["sd"][f"{LAYER}.weight"].numpy(), jk, atol=5e-4)
    np.testing.assert_allclose(r0["mu"].numpy(), jmu, atol=5e-4)
    np.testing.assert_allclose(r0["nu"].numpy(), jnu, atol=5e-4)
    for k, v in one["sd"].items():
        np.testing.assert_allclose(r0["sd"][k].numpy(), v.numpy(), atol=5e-4, err_msg=k)
    # the moments against JAX's and one process's also relative to their
    # size (1e-3 of the largest): a gradient summed twice doubles μ
    for got, refs in (("mu", (jmu, one["mu"].numpy())), ("nu", (jnu, one["nu"].numpy()))):
        for ref in refs:
            np.testing.assert_allclose(r0[got].numpy(), ref, rtol=1e-3,
                                       atol=1e-3 * np.abs(ref).max(), err_msg=got)
    # the sharded layer's own update is the one-process update (its
    # gradient is whole on each rank: not summed twice, not halved)
    w_step = (r0["sd"][f"{LAYER}.weight"] - whole0).numpy()
    np.testing.assert_allclose(w_step, (one["sd"][f"{LAYER}.weight"] - whole0).numpy(),
                               rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("mode", ["f32", "bf16", "factored", "both"])
def test_moment_levers_on_a_sharded_weight(mode):
    """``AdamMoments`` on a weight column-sharded over 4 ranks (2, 2)
    against JAX ``scale_by_adam_moments`` on the whole kernel, three steps:
    the gathered update, μ and ν; the factored ν's row factor covers every
    rank's rows (the same on every rank), its column factor is the rank's."""
    bf16 = mode in ("bf16", "both")
    min_size = 1024 if mode in ("factored", "both") else None
    lr, wd = 1e-3, 1e-2
    rng = np.random.default_rng(3)
    w0 = (1e-3 * rng.normal(size=(64, 24))).astype(np.float32)  # torch (out, in)
    grads = [(rng.normal(size=w0.shape) * 10.0 ** (s - 1)).astype(np.float32) for s in range(3)]
    tx = optax.chain(optax.add_decayed_weights(wd), scale_by_adam_moments(
        moment_dtype=jnp.bfloat16 if bf16 else None, factored_nu_min_size=min_size))
    jp = jnp.asarray(w0.T)
    jstate = tx.init(jp)
    for g in grads:
        u, jstate = tx.update(jnp.asarray(g.T), jstate, jp)
        jp = jp - lr * u
    adam = jstate[1]

    def rank(mesh):
        lin = nn.Linear(24, 64, bias=False)
        with torch.no_grad():
            lin.weight.copy_(torch.tensor(w0))
        holder = nn.Sequential(lin)
        tdense.shard_large_dense(holder, mesh, 1024)
        p = holder[0].weight
        shard = p.column_shard
        opt = AdamMoments([p], lr=lr, weight_decay=wd,
                          moment_dtype=torch.bfloat16 if bf16 else None,
                          factored_nu_min_size=min_size)
        for g in grads:
            p.grad = torch.tensor(g[shard.lo:shard.hi])
            opt.step()
        st = opt.state[p]
        return (shard.gather(p), shard.gather(st["exp_avg"].float()),
                {k: v.clone() for k, v in st.items() if k != "step"}, (shard.lo, shard.hi))

    outs = run_ranks(4, rank, (2, 2))
    w, mu = outs[0][0], outs[0][1]
    ulp2 = 2 * float(np.spacing(np.abs(w0)).max())
    np.testing.assert_allclose(w.numpy(), np.asarray(jp).T, rtol=1e-6, atol=ulp2 + 1e-9)
    mu_ref = np.asarray(adam.mu.astype(jnp.float32)).T
    if bf16:
        _bf16_ulp_close(mu.to(torch.bfloat16), mu_ref)
    else:
        np.testing.assert_allclose(mu.numpy(), mu_ref, rtol=1e-6, atol=1e-12)
    for (_w, _mu, st, (lo, hi)) in outs:
        if min_size:
            assert "exp_avg_sq" not in st and st["nu_row"].shape == (24,)
            np.testing.assert_allclose(st["nu_row"].numpy(), np.asarray(adam.nu.row), rtol=1e-6)
            assert torch.equal(st["nu_row"], outs[0][2]["nu_row"])
            np.testing.assert_allclose(st["nu_col"].numpy(), np.asarray(adam.nu.col)[lo:hi],
                                       rtol=1e-6)
        else:
            nu_ref = np.asarray(adam.nu.astype(jnp.float32)).T[lo:hi]
            if bf16:
                _bf16_ulp_close(st["exp_avg_sq"], nu_ref)
            else:
                np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu_ref, rtol=1e-6)


def test_untiled_and_small_leaves_stay_replicated():
    """The JAX condition: a 2-D leaf of at least ``min_elems`` elements
    whose output features tile the mesh; the bias (1-D), a layer below the
    size and one whose rows do not tile stay whole ``nn.Linear``s; no mesh
    or a one-rank mesh shards nothing."""
    mesh = tmesh.Mesh((4, 1), data_group=object())
    mod = nn.Sequential(nn.Linear(32, 128), nn.Linear(64, 66), nn.Linear(8, 16))
    opt = torch.optim.Adam(mod.parameters())
    for p in mod.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    whole = mod[0].weight.detach().clone()
    tdense.shard_large_dense(mod, mesh, 2048, opt=opt)
    assert isinstance(mod[0], tdense.ColumnShardedLinear)
    assert mod[0].weight.shape == (32, 32) and mod[0].bias.shape == (128,)
    assert torch.equal(mod[0].weight, whole[:32])  # rank 0
    assert opt.state[mod[0].weight]["exp_avg"].shape == (32, 32)
    assert opt.state[mod[0].bias]["exp_avg"].shape == (128,)
    assert type(mod[1]) is nn.Linear and mod[1].weight.shape == (66, 64)  # 66 % 4 != 0
    assert type(mod[2]) is nn.Linear  # 128 elements < 2048
    for m in (None, tmesh.Mesh((1, 1))):
        one = nn.Sequential(nn.Linear(32, 128))
        tdense.shard_large_dense(one, m, 1)
        assert type(one[0]) is nn.Linear


def test_graph_sharded_path_shards_the_layer(graphs, jax_dense):  # noqa: F811
    """The graph-sharded (1, 2) path column-shards the layer too (the data
    axis is 1, so every rank has the whole input): one fed step against
    the port's one-process step, the gathered layer the same on both
    ranks."""
    state, feed, _single, _sharded, imgs = jax_dense
    cfg = dict(CFG, GRAPH_SHARDED="on")
    one = _rank_step(graphs, state, feed, imgs, None)
    outs = run_ranks(2, lambda mesh: _rank_step(graphs, state, feed, imgs, mesh, cfg), (1, 2))
    for o in outs:
        assert o["kind"] == "ColumnShardedLinear" and o["grad_rows"] == 64
        assert o["ts"].dvae_opt.state[o["ts"].dvae._decoder.increase_latent_dim.weight][
            "exp_avg"].shape == (64, 32)
        np.testing.assert_allclose(float(o["m"].mse), float(one["m"].mse), rtol=1e-4)
        np.testing.assert_allclose(float(o["m"].dvae_loss), float(one["m"].dvae_loss), rtol=1e-3)
        assert torch.equal(o["sd"][f"{LAYER}.weight"], outs[0]["sd"][f"{LAYER}.weight"])
    np.testing.assert_allclose(outs[0]["sd"][f"{LAYER}.weight"].numpy(),
                               one["sd"][f"{LAYER}.weight"].numpy(), atol=5e-4)


def test_save_on_a_mesh_writes_the_whole_layer(tmp_path, monkeypatch):
    """``Trainer.save`` on (2, 2) ranks with the layer sharded: every rank
    gathers it, rank 0 writes ``dvae.pth`` with the whole (128, 32) weight,
    equal to the gathered one; ``generate_output`` decodes through the
    sharded layer on every rank, the same images on each."""
    monkeypatch.setattr(tstep, "DENSE_MIN_ELEMS", MIN_ELEMS)
    cfg = TrainingConfig(N_LATENTS=32, NUM_READS=8, BATCH_SIZE=8, DATASET_SIZE=16,
                         N_REPLICAS=2, GIBBS_SWEEPS=2, GIBBS_BURN_IN=2,
                         QPU="Advantage2_prototype", COMPUTE_DTYPE="float32")

    def rank(mesh):
        t = Trainer(cfg, device="cpu", mesh=mesh)
        t.train_init(1)
        t.train_epoch(0)
        layer = t.dvae._decoder.increase_latent_dim
        t.save(tmp_path / "m")
        out = t.generate_output(num_reads=8)
        return (type(layer).__name__, tdense.gather_large_dense(t.dvae)[f"{LAYER}.weight"],
                out["images"])

    outs = run_ranks(4, rank, (2, 2))
    saved = load_state_dict(tmp_path / "m" / "dvae.pth")[f"{LAYER}.weight"]
    assert saved.shape == (128, 32)
    for kind, w, imgs in outs:
        assert kind == "ColumnShardedLinear"
        assert torch.equal(w, saved)
        assert imgs.shape == (8, 32, 32, 1) and np.array_equal(imgs, outs[0][2])
