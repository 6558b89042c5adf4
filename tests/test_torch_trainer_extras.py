"""Port parity: the Trainer surface around the sweep kernels on the CPU.

``training/observability.py`` (``MetricsLog`` records as the JAX
package's, the profiler trace), ``io/native_ckpt.py`` with
``Trainer.save_native`` / ``resume_native`` / ``train(checkpoint_dir=)``
(the round trip, the derived sampler cache left out and rebuilt, schema
and shape refusals, a resumed run equal to the uninterrupted one, the
start-epoch cases of tests/test_resume_and_modes.py), and
``PT_NUM_BETAS="auto"`` (``ops/pt_tune.py``'s probe against the JAX
package's with the draws JAX makes from its keys fed to the port, and the
Trainer's resolution at ``train_init`` and ``load``).

Tolerances: swap acceptance within 1e-5 of JAX's (f32 energies summed in
another order move e^{Δβ·ΔE} by an ulp or so); everything else exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_generation_tpu.models import grbm as jgrbm
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.ops import pt_tune as jpt
from image_generation_tpu.training.observability import MetricsLog as JaxMetricsLog
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.io import native_ckpt
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops import pt_tune as tpt
from image_generation_tpu_torch.training.observability import MetricsLog, profile
from image_generation_tpu_torch.training.step import make_sample_fns
from image_generation_tpu_torch.training.trainer import Trainer, TrainingError
from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph
from test_torch_pt import _jax_round_draws, _t

SEED = 775321899904
TINY = dict(N_LATENTS=32, NUM_READS=8, BATCH_SIZE=8, DATASET_SIZE=16, N_REPLICAS=1,
            GIBBS_SWEEPS=2, GIBBS_BURN_IN=2, PT_NUM_BETAS=3, COMPUTE_DTYPE="float32",
            QPU="Advantage2_prototype")


def _cfg(**kw):
    return TrainingConfig(**{**TINY, **kw})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These runs are thousands of tiny tensor ops: one intra-op thread
    for this module (the suite runs six worker processes at once, and a
    pool of threads spinning for work slows every small op), restored
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

def test_metrics_log_records_match_jax(tmp_path):
    fields = dict(epoch=3, mse=0.25, dvae_loss=0.5, pt_accept_min=0.1, pt_betas=[0.5, 1.0])
    ours, theirs = MetricsLog(tmp_path / "a" / "m.jsonl"), JaxMetricsLog(tmp_path / "b" / "m.jsonl")
    a, b = ours.log("epoch", **fields), theirs.log("epoch", **fields)
    assert list(a) == list(b) and {k: a[k] for k in fields} == {k: b[k] for k in fields}
    ours.log("done")
    assert [r["event"] for r in ours.read()] == ["epoch", "done"]
    assert MetricsLog(tmp_path / "none.jsonl").read() == []


@pytest.mark.parametrize("sampler", ["gibbs", "pt"])
def test_train_writes_metrics_profile_and_checkpoints(tmp_path, sampler):
    """``train(metrics_log=, profile_dir=, checkpoint_dir=)``: one JAX-shaped
    record per epoch (the keys JAX's ``train`` writes: ``train_epoch``'s
    stats plus epoch time and images/s), one trace, a checkpoint and its
    loss history per epoch."""
    t = Trainer(config=_cfg(SAMPLER=sampler), device="cpu")
    log = MetricsLog(tmp_path / "metrics.jsonl")
    t.train(2, metrics_log=log, profile_dir=str(tmp_path / "prof"),
            checkpoint_dir=tmp_path / "ck")
    recs = log.read()
    want = {"event", "t", "epoch", "mse", "dvae_loss", "epoch_time_s", "images_per_s"}
    if sampler == "pt":
        want |= {"pt_accept_min", "pt_accept_mean", "pt_recommended_num_betas"}
    assert [r["epoch"] for r in recs] == [0, 1] and all(set(r) == want for r in recs)
    assert recs[1]["mse"] == pytest.approx(np.mean(t.losses["mse_losses"][2:]))
    assert len(list((tmp_path / "prof").glob("trace_*.json"))) == 1
    names = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert names == ["losses_step_00000002.json", "losses_step_00000004.json",
                     "step_00000002.pt", "step_00000004.pt"]
    assert native_ckpt.latest_step(tmp_path / "ck") == 4
    assert native_ckpt.latest_step(tmp_path / "none") is None


def test_profile_is_a_no_op_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("IMGGEN_PROFILE_DIR", raising=False)
    with profile(None) as d:
        assert d is None
    monkeypatch.setenv("IMGGEN_PROFILE_DIR", str(tmp_path / "env"))
    with profile() as d:
        torch.ones(3).sum()
    assert d == str(tmp_path / "env") and list((tmp_path / "env").glob("trace_*.json"))


# ---------------------------------------------------------------------------
# native checkpoints and resume
# ---------------------------------------------------------------------------

def _states_equal(a, b):
    for k, v in a.dvae.state_dict().items():
        assert torch.equal(v, b.dvae.state_dict()[k]), k
    for x, y in ((a.grbm_params.linear, b.grbm_params.linear),
                 (a.grbm_params.quadratic, b.grbm_params.quadratic), (a.chains, b.chains),
                 (a.chain_energies, b.chain_energies), (a.pt_betas, b.pt_betas),
                 (a.generator.get_state(), b.generator.get_state())):
        assert torch.equal(x, y)
    assert a.opt_step == b.opt_step
    for oa, ob in ((a.dvae_opt, b.dvae_opt), (a.grbm_opt, b.grbm_opt)):
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        assert sa.keys() == sb.keys()
        for i in sa:
            for k in sa[i]:
                assert torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k]))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_native_round_trip_leaves_out_and_rebuilds_the_sampler_cache(tmp_path, dtype):
    t = Trainer(config=_cfg(SAMPLER="pt", SAMPLER_MATMUL_DTYPE=dtype), device="cpu")
    t.train(1)
    path = t.save_native(tmp_path)
    payload = native_ckpt.load_payload(tmp_path)
    assert payload["schema"] == native_ckpt.SCHEMA and payload["opt_step"] == 2
    assert not {"sampler_h", "sampler_coupling"} & set(payload)
    assert path.name == "step_00000002.pt"
    t2 = Trainer(config=t.config, device="cpu")
    t2.train_init(1)
    native_ckpt.restore_train_state(tmp_path, t2.state, rebuild_cache=t2.fns.rebuild_cache)
    _states_equal(t.state, t2.state)
    assert torch.equal(t2.state.sampler_h, t.state.sampler_h)
    c1, c2 = t.state.sampler_coupling, t2.state.sampler_coupling
    if dtype == "int8":
        assert torch.equal(c1.q, c2.q) and torch.equal(c1.scale, c2.scale)
    else:
        assert torch.equal(c1, c2)


def test_native_restore_refuses_another_schema_or_shape(tmp_path):
    t = Trainer(config=_cfg(SAMPLER="pt"), device="cpu")
    t.train_init(1)
    t.save_native(tmp_path / "pt")
    other = Trainer(config=_cfg(SAMPLER="pt", PT_NUM_BETAS=4), device="cpu")
    other.train_init(1)
    with pytest.raises(ValueError, match="'chains'"):
        native_ckpt.restore_train_state(tmp_path / "pt", other.state)
    torch.save({"schema": "something-else"}, tmp_path / "pt" / "step_00000009.pt")
    with pytest.raises(ValueError, match="schema"):
        native_ckpt.restore_train_state(tmp_path / "pt", t.state)
    with pytest.raises(FileNotFoundError):
        native_ckpt.restore_train_state(tmp_path / "empty", t.state)
    with pytest.raises(TrainingError):
        Trainer(config=_cfg(), device="cpu").save_native(tmp_path / "x")


@pytest.mark.parametrize("sampler", ["gibbs", "pt"])
def test_resume_equals_the_uninterrupted_run(tmp_path, sampler):
    """Two epochs in one go, against one epoch, a native checkpoint, and the
    second epoch in a fresh Trainer: the same weights, optimizer moments,
    chains, ladder energies, generator and loss history (the checkpoint
    carries the trainer's seed stream, so the resumed epoch permutes the
    data as the uninterrupted one did)."""
    cfg = _cfg(SAMPLER=sampler)
    full = Trainer(config=cfg, device="cpu")
    full.train(2)
    part = Trainer(config=cfg, device="cpu")
    part.train_init(2)
    part.train_epoch(0)
    part.save_native(tmp_path)
    resumed = Trainer(config=cfg, device="cpu")
    assert resumed.resume_native(tmp_path, n_epochs=2) == 2
    ran = []
    resumed.train(2, epoch_cb=lambda e, _s: ran.append(e))
    assert ran == [1]
    _states_equal(full.state, resumed.state)
    assert resumed.losses == full.losses


def test_resume_continues_at_the_right_epoch(tmp_path):
    """tests/test_resume_and_modes.py's cases: the first ``train`` after
    ``resume_native`` continues at the epoch the run stopped in; the hint is
    consumed once; an explicit ``start_epoch`` is honoured."""
    t = Trainer(config=_cfg(), device="cpu")
    t.train_init(3)
    t.train_epoch(0)
    t.save_native(tmp_path / "ck")
    t2 = Trainer(config=_cfg(), device="cpu")
    assert t2.resume_native(tmp_path / "ck", n_epochs=3) == t2.n_batches
    ran = []
    t2.train(3, epoch_cb=lambda e, _s: ran.append(e))
    assert ran == [1, 2]
    again = []
    t2.train(3, epoch_cb=lambda e, _s: again.append(e))
    assert again == [0, 1, 2]
    t3 = Trainer(config=_cfg(), device="cpu")
    t3.resume_native(tmp_path / "ck", n_epochs=3)
    ran3 = []
    t3.train(3, epoch_cb=lambda e, _s: ran3.append(e), start_epoch=2)
    assert ran3 == [2]


def test_resume_hint_is_consumed_even_with_an_explicit_start(tmp_path):
    """Where the port differs from the JAX package (ADVICE.md's finding at
    JAX trainer.py:365): the first ``train`` after ``resume_native``
    consumes the hint even when it passes ``start_epoch``, so a later call
    without one re-runs from epoch 0."""
    t = Trainer(config=_cfg(), device="cpu")
    t.train_init(2)
    t.train_epoch(0)
    t.save_native(tmp_path)
    t2 = Trainer(config=_cfg(), device="cpu")
    t2.resume_native(tmp_path, n_epochs=2)
    first, second = [], []
    t2.train(2, epoch_cb=lambda e, _s: first.append(e), start_epoch=1)
    t2.train(2, epoch_cb=lambda e, _s: second.append(e))
    assert first == [1] and second == [0, 1]


def test_second_train_call_reruns():
    t = Trainer(config=_cfg(), device="cpu")
    ran = []
    t.train(1, epoch_cb=lambda e, _s: ran.append(e))
    t.train(1, epoch_cb=lambda e, _s: ran.append(e))
    assert ran == [0, 0]


def test_resume_native_rebuilds_for_new_epoch_budget(tmp_path):
    t = Trainer(config=_cfg(), device="cpu")
    t.train_init(1)
    t.train_epoch(0)
    t.save_native(tmp_path)
    t2 = Trainer(config=_cfg(), device="cpu")
    t2.train_init(1)  # built for the wrong budget
    t2.resume_native(tmp_path, n_epochs=4)
    assert t2._n_epochs == 4
    assert t2.fns.dvae_lr(2 * t2.n_batches) > t2.fns.dvae_lr(4 * t2.n_batches - 1)


# ---------------------------------------------------------------------------
# the acceptance probe and PT_NUM_BETAS="auto"
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def glass():
    """The 32-latent prototype graph with a frustrated ±1.2 J (zero h), in
    both packages, as numpy (hp, A)."""
    tg, _ = cached_latent_graph("Advantage2_prototype", 32, SEED)
    jg = jgrbm.GRBMGraph(n=tg.n, edge_i=tg.edge_i, edge_j=tg.edge_j)
    jplan, tplan = jgibbs.build_plan(jg), tgibbs.build_plan(tg)
    j = np.random.default_rng(7).choice([-1.2, 1.2], tg.n_edges).astype(np.float32)
    hp, a = jgibbs.permuted_model(jplan, jnp.zeros(tg.n, jnp.float32), jnp.asarray(j))
    return jplan, tplan, np.asarray(hp), np.asarray(a)


def test_swap_acceptance_matches_jax_with_fed_draws(glass):
    """JAX's ``swap_acceptance`` (its jitted burn + measure scans) against
    the port's, fed the initial ladder and every round's sweep and swap
    uniforms JAX draws from its keys."""
    jplan, tplan, hp, a = glass
    betas = np.geomspace(0.3, 1.0, 4)
    kw = dict(n_chains=8, n_rounds=3, sweeps_per_round=2, burn_rounds=2)
    key = jax.random.PRNGKey(5)
    ref = jpt.swap_acceptance(key, jnp.asarray(hp), jnp.asarray(a), jplan, betas, **kw)
    k_init, k_run = jax.random.split(key)
    init = _t(np.asarray(jgibbs.random_spins(k_init, jplan, 4 * 8)))
    keys = list(jax.random.split(jax.random.fold_in(k_run, 0), 2)) + list(
        jax.random.split(jax.random.fold_in(k_run, 1), 3))
    feed = [_jax_round_draws(k, jplan, 4, 8, 2) for k in keys]
    ours = tpt.swap_acceptance(None, _t(hp), _t(a), tplan, betas, **kw, init_spins=init,
                               feed=feed)
    np.testing.assert_array_equal(ours.betas, ref.betas)
    np.testing.assert_allclose(ours.accept, ref.accept, rtol=0, atol=1e-5)
    assert ours.barrier == pytest.approx(ref.barrier, abs=1e-4)
    assert (ours.accept < 0.999).any()  # the glass rejects some swaps


def test_round_trip_count_matches_jax_with_fed_draws(glass):
    jplan, tplan, hp, a = glass
    betas = np.array([1.0, 1.0])  # every swap accepted: replicas shuttle freely
    key = jax.random.PRNGKey(4)
    ref = jpt.round_trip_count(key, jnp.asarray(hp), jnp.asarray(a), jplan, betas,
                               n_chains=8, n_rounds=6)
    k_init, k_run = jax.random.split(key)
    init = _t(np.asarray(jgibbs.random_spins(k_init, jplan, 2 * 8)))
    feed = [_jax_round_draws(k, jplan, 2, 8, 2) for k in jax.random.split(k_run, 6)]
    ours = tpt.round_trip_count(None, _t(hp), _t(a), tplan, betas, 8, 6, init_spins=init,
                                feed=feed)
    assert ours == (int(ref[0]), pytest.approx(ref[1]))
    assert ours[1] == 1.0 and ours[0] > 10
    many = tpt.round_trip_count(torch.Generator().manual_seed(0), _t(hp), _t(a), tplan,
                                [np.geomspace(0.2, 1.0, 4)] * 2, 8, 4)
    assert len(many) == 2 and many[0] == many[1]


def test_size_ladder_matches_jax_where_unambiguous(glass):
    """Where the rung count does not hang on the draws.  A zero model
    accepts every swap: T = t_min = 2, the probe's ends.  2,048 free spins
    in unit fields (the 2,048-latent plan, no coupling) reject every swap,
    their energies lying some Δβ·2048 apart between rungs: T = t_max = 4,
    the probe's own rungs."""
    jplan, tplan, hp, a = glass
    kw = dict(beta_min=0.25, n_chains=8, n_rounds=3, burn_rounds=2)
    cases = [(jplan, tplan, hp, a * 0.0, dict(t_probe=8, t_max=8), 2)]
    tg, _ = cached_latent_graph("Advantage_system6", 2048, SEED)
    jg = jgrbm.GRBMGraph(n=tg.n, edge_i=tg.edge_i, edge_j=tg.edge_j)
    jplan2, tplan2 = jgibbs.build_plan(jg), tgibbs.build_plan(tg)
    h = np.random.default_rng(1).choice([-1.0, 1.0], tg.n).astype(np.float32)
    hp2, a2 = jgibbs.permuted_model(jplan2, jnp.asarray(h), jnp.zeros(tg.n_edges, jnp.float32))
    cases.append((jplan2, tplan2, np.asarray(hp2), np.asarray(a2), dict(t_probe=4, t_max=4), 4))
    for jp, tp, h_, a_, sizes, want in cases:
        ref, rdiag = jpt.size_ladder(jax.random.PRNGKey(2), jnp.asarray(h_), jnp.asarray(a_), jp,
                                     **kw, **sizes)
        ours, diag = tpt.size_ladder(torch.Generator().manual_seed(2), _t(h_), _t(a_), tp,
                                     **kw, **sizes)
        assert len(ours) == len(ref) == want
        np.testing.assert_allclose(ours, ref, rtol=1e-12)
        assert ours[-1] == 1.0 and ours[0] == 0.25 and np.all(np.diff(ours) > 0)
        np.testing.assert_array_equal(diag.betas, rdiag.betas)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_trainer_resolves_auto_ladder(dtype, tmp_path):
    """``PT_NUM_BETAS="auto"``: ``train_init`` probes the initial model
    through the dispatch (as the JAX test tests/test_pt_tune.py checks:
    a concrete ladder frozen into the config, chains of that size, the
    near-zero initial model needs few rungs); ``load`` resolves it for the
    loaded model; unresolved, the sampler functions refuse."""
    cfg = _cfg(SAMPLER="pt", PT_NUM_BETAS="auto", SAMPLER_MATMUL_DTYPE=dtype)
    with pytest.raises(RuntimeError, match="auto"):
        cfg.initial_pt_betas()
    t = Trainer(config=cfg, device="cpu")
    t.setup()
    with pytest.raises(ValueError, match="resolved"):
        make_sample_fns(cfg, t.graph, t.plan, device="cpu")
    t.train_init(1)
    n = t.config.PT_NUM_BETAS
    assert isinstance(n, int) and 2 <= n <= 8 and len(t.config.PT_BETAS) == n
    assert t.state.chains.shape[:2] == (n, cfg.NUM_READS)
    assert t.pt_auto_info["num_betas"] == n and t.pt_auto_info["probe_rungs"] >= 16
    assert t.pt_auto_info["probe_sampler"] == "cuda_vmem" + ("+int8" if dtype == "int8" else "")
    assert t.train_epoch(0)["pt_recommended_num_betas"] >= 2
    t.save(tmp_path / "m")
    loaded = Trainer(config=cfg, device="cpu")
    loaded.load(tmp_path / "m")
    assert isinstance(loaded.config.PT_NUM_BETAS, int) and loaded.pt_auto_info is not None
    assert loaded.sample_spins(4, 4).shape == (4, 32)
    json.dumps(loaded.pt_auto_info)


def test_auto_ladder_refuses_a_beyond_one_device_plan_as_jax(monkeypatch):
    """``PT_NUM_BETAS="auto"`` on one device with a P32-sized plan (n_pad
    23,936: a 2.29 GB f32 coupling, over the 2 GiB line): both packages
    raise ``ValueError`` naming ``tune-pt`` before anything is built (the
    JAX reference ``trainer.py:181``).  Below the line a mesh is no longer
    refused, as in the JAX package: every rank builds the one-device
    probe."""
    from types import SimpleNamespace

    from image_generation_tpu.config import TrainingConfig as JaxConfig
    from image_generation_tpu.training import trainer as jtrainer
    from image_generation_tpu_torch.training import trainer as ttrainer

    def never(*_a, **_k):
        raise AssertionError("the refusal must come before a coupling is built")

    plan = SimpleNamespace(n_pad=23936)
    graph = SimpleNamespace(init_params=never)
    monkeypatch.setattr(jgibbs, "permuted_model", never)
    monkeypatch.setattr(ttrainer, "make_sample_fns", never)
    jt = jtrainer.Trainer(config=JaxConfig(SAMPLER="pt", PT_NUM_BETAS="auto"), mesh=None)
    tt = Trainer(config=TrainingConfig(SAMPLER="pt", PT_NUM_BETAS="auto"), device="cpu")
    for t in (jt, tt):
        t.plan, t.graph = plan, graph
        with pytest.raises(ValueError, match="tune-pt"):
            t._resolve_auto_ladder()
    tt.plan = SimpleNamespace(n_pad=768)  # below the line, on a mesh: probed
    tt.mesh = object()

    class Probed(Exception):
        pass

    def probe(*_a, **kw):
        assert "mesh" not in kw  # the one-device probe, on every rank alike
        raise Probed

    monkeypatch.setattr(ttrainer, "make_sample_fns", probe)
    with pytest.raises(Probed):
        tt._resolve_auto_ladder()
