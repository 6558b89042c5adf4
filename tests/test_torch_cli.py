"""Port parity: the CLI (``app/cli.py``) and its helpers, on the CPU.

The JAX package is the oracle for what does not depend on a draw: the
parser's subcommands and option strings, ``validate_extra_cli``,
``parse_serving_args``, ``_parse_pt_betas``, ``TrainingConfig.
parse_overrides`` (without PyYAML, value for value), ``save_png`` (decoded
here through PIL to the same uint8 array) and ``tune_pt_betas`` with the
draws JAX makes from its keys fed to the port (the ladder within 1e-5:
swap acceptance moves by f32 ulps between the two energy sums).  The
whole port CLI runs train → generate --sharpen → generate --sampler pt →
tune → refresh → tune-pt → models at the tiny size (32 latents on
Advantage2_prototype, dataset 64, batch 16, 2 sweeps), writing the files
JAX's ``cli.main`` writes (tests/test_torch_cli_jax_*.py run the JAX CLI
beside it).
"""

import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_generation_tpu.app import cli as jcli
from image_generation_tpu.app.diagram import save_png as jax_save_png
from image_generation_tpu.config import TrainingConfig as JaxConfig
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.ops import pt_tune as jpt
from image_generation_tpu_torch.app import cli
from image_generation_tpu_torch.app.diagram import save_png
from image_generation_tpu_torch.app.warm import WarmGenerator
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops import pt_tune as tpt
from test_torch_pt import _jax_round_draws, _t
from test_torch_trainer_extras import glass  # noqa: F401  (a fixture)

TINY = ["--dataset-size", "64", "--batch-size", "16", "--latents", "32", "--sweeps", "2",
        "--qpu", "Advantage2_prototype", "--platform", "cpu"]
# what JAX's cli.main writes (tests/test_torch_cli_jax_*.py hold the two side by side)
GENERATED = {"generated_epoch_0.json", "loss_mse_epoch_0.json", "loss_total_epoch_0.json",
             "problem_details.json", "reconstructed_epoch_0.json"}
DIAGRAM = {"latent_encoded.json", "latent_qpu.json", "step_1_input.png", "step_2_encode.png",
           "step_4_decode.png", "step_5_output.png"}
MODEL_FILES = {"dvae.pth", "grbm.pth", "losses.json", "parameters.json"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny tensor ops: one intra-op thread for this module (the suite
    runs six worker processes at once), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _names(d):
    return {p.name for p in d.iterdir()} if d.exists() else set()


# ---------------------------------------------------------------------------
# the parser and its helpers
# ---------------------------------------------------------------------------

def _surface(ap):
    """{subcommand: {option string: (default, choices, type, required)}}."""
    def opts(p):
        return {s: (a.default, a.choices, a.type, a.required)
                for a in p._actions for s in a.option_strings if s not in ("-h", "--help")}

    out = {"": opts(ap)}
    for act in ap._actions:
        if act.__class__.__name__ == "_SubParsersAction":
            out.update({name: opts(sub) for name, sub in act.choices.items()})
    return out


def test_build_parser_matches_jax():
    ours, theirs = _surface(cli.build_parser()), _surface(jcli.build_parser())
    assert set(ours) == set(theirs) == {"", "train", "generate", "tune", "refresh", "tune-pt",
                                        "models"}
    for cmd in theirs:
        assert ours[cmd] == theirs[cmd], cmd


@pytest.mark.parametrize("extra", [
    [], ["--sampler", "pt", "--serve-max-batch", "4"], ["--latents=64", "--epochs", "2"],
    ["--warm-genrate"], ["--sampler", "pt", "--nope=1", "--also-bad"],
])
def test_validate_extra_cli_matches_jax(extra):
    try:
        jcli.validate_extra_cli(extra)
        theirs = None
    except SystemExit as e:
        theirs = str(e).split(":")[0]
    if theirs is None:
        cli.validate_extra_cli(extra)
    else:
        with pytest.raises(SystemExit) as ours:
            cli.validate_extra_cli(extra)
        assert str(ours.value).split(":")[0] == theirs


def test_parse_serving_args_matches_jax():
    extra = ["--sampler-matmul-dtype", "int8", "--pt-betas", "0.5,1.0", "--epochs", "3",
             "--sweeps", "4"]
    ours, theirs = vars(cli.parse_serving_args(extra)), vars(jcli.parse_serving_args(extra))
    ours.pop("fn"), theirs.pop("fn")
    assert ours == theirs
    assert cli._config_overrides(cli.parse_serving_args(extra)) == jcli._config_overrides(
        jcli.parse_serving_args(extra))


def test_parse_pt_betas_matches_jax(tmp_path):
    good = tmp_path / "pt_betas.json"
    good.write_text(json.dumps({"betas": [0.25, 0.5, 1.0]}))
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    for spec in ("0.25,0.5,1", str(good)):
        assert cli._parse_pt_betas(spec) == jcli._parse_pt_betas(spec)
    for spec in (str(bad), "0.2,x,1"):
        with pytest.raises(SystemExit) as theirs:
            jcli._parse_pt_betas(spec)
        with pytest.raises(SystemExit) as ours:
            cli._parse_pt_betas(spec)
        assert str(ours.value) == str(theirs.value)


def test_parse_mesh_ports_one_by_p_only():
    assert cli.parse_mesh("off") is None and cli.parse_mesh("auto") == "auto"
    for spec, words in (("8", "item 7"), ("2x4", "item 7"), ("1x2", "not initialised"),
                        ("1xq", "must be")):
        with pytest.raises(SystemExit, match=words):
            cli.parse_mesh(spec)


def test_parse_mesh_builds_the_graph_mesh_of_an_initialised_world():
    """1xP over an initialised process group: here a one-rank gloo world."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        mesh = cli.parse_mesh("1x1")
        assert mesh.shape == (1, 1) and mesh.graph_index == 0 and mesh.backend == "gloo"
        with pytest.raises(SystemExit, match="1 ranks"):
            cli.parse_mesh("1x2")
    finally:
        dist.destroy_process_group()


VALUE_FORMS = ["on", "off", "yes", "no", "On", "TRUE", "null", "~", "", "32", "0x10", "1_000",
               "1.0e-3", "1e-3", "1.0e3", "[0.5,1]", "[0.5, 1.0, 2]", "-7", "010", "0b101",
               "1:30", ".5", ".inf", "-.inf", ".nan", "auto", "bfloat16", "'on'", '"x y"',
               "{a: 1}", "2001-12-14", "12 # note", "[on, null, 'x']"]


@pytest.mark.parametrize("value", VALUE_FORMS)
def test_parse_overrides_matches_jax_yaml(value):
    pairs = [f"PT_BETAS={value}", f"GRAPH_SHARDED={value}"]
    ours, theirs = TrainingConfig.parse_overrides(pairs), JaxConfig.parse_overrides(pairs)
    assert ours.keys() == theirs.keys()
    for k in ours:
        a, b = ours[k], theirs[k]
        if isinstance(b, float) and math.isnan(b):
            assert isinstance(a, float) and math.isnan(a)
        else:
            assert repr(a) == repr(b), (value, a, b)


def test_parse_overrides_refusals_and_typed_config():
    for bad in (["NOPE=1"], ["NUM_READS"], ["=3"]):
        with pytest.raises(SystemExit) as theirs:
            JaxConfig.parse_overrides(bad)
        with pytest.raises(SystemExit) as ours:
            TrainingConfig.parse_overrides(bad)
        assert str(ours.value) == str(theirs.value)
    kw = TrainingConfig.parse_overrides(["GRAPH_SHARDED=on", "PT_BETAS=[0.5,1]",
                                         "NUM_READS=0x40", "PT_ADAPT=off"])
    cfg = TrainingConfig(**kw)
    assert (cfg.GRAPH_SHARDED, cfg.PT_BETAS, cfg.NUM_READS, cfg.PT_ADAPT) == (
        "on", (0.5, 1.0), 64, "off")


def test_params_yaml_reads_like_jax_and_names_pyyaml_when_absent(tmp_path, monkeypatch):
    p = tmp_path / "params.yaml"
    p.write_text("NUM_READS: 64\nGRAPH_SHARDED: off\nPT_BETAS: [0.5, 1.0]\nUNKNOWN: 3\n")
    ours, theirs = TrainingConfig.from_yaml(p, BATCH_SIZE=8), JaxConfig.from_yaml(p, BATCH_SIZE=8)
    assert (ours.NUM_READS, ours.GRAPH_SHARDED, ours.PT_BETAS, ours.BATCH_SIZE) == (
        theirs.NUM_READS, theirs.GRAPH_SHARDED, theirs.PT_BETAS, theirs.BATCH_SIZE)
    monkeypatch.setitem(sys.modules, "yaml", None)  # as on a machine without PyYAML
    with pytest.raises(ModuleNotFoundError, match="PyYAML"):
        TrainingConfig.from_yaml(p)
    with pytest.raises(ModuleNotFoundError, match="PyYAML"):
        cli.main(["--workdir", str(tmp_path), "train", "--name", "m", "--params", str(p)] + TINY)
    assert TrainingConfig.parse_overrides(["NUM_READS=8"]) == {"NUM_READS": 8}


@pytest.mark.parametrize("shape", [(32, 32), (32, 32, 1), (5, 7, 3), (1, 1), (70, 546, 1)])
def test_save_png_decodes_like_jax(tmp_path, shape):
    img = np.random.default_rng(len(shape)).random(shape).astype(np.float32) * 1.2 - 0.1
    img.flat[0], img.flat[-1] = 1.0, 0.0
    save_png(img, tmp_path / "ours.png")
    jax_save_png(img, tmp_path / "theirs.png")
    ours, theirs = (np.asarray(Image.open(tmp_path / n)) for n in ("ours.png", "theirs.png"))
    assert ours.dtype == theirs.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


def _measurement_feed(k, jplan, t_dim, n_chains, burn, rounds):
    """(initial spins, round draws) JAX's ``swap_acceptance`` makes from ``k``."""
    k_init, k_run = jax.random.split(k)
    init = _t(np.asarray(jgibbs.random_spins(k_init, jplan, t_dim * n_chains)))
    keys = list(jax.random.split(jax.random.fold_in(k_run, 0), burn)) + list(
        jax.random.split(jax.random.fold_in(k_run, 1), rounds))
    return init, [_jax_round_draws(kk, jplan, t_dim, n_chains, 2) for kk in keys]


def test_tune_pt_betas_matches_jax_with_fed_draws(glass):  # noqa: F811
    """Two feedback iterations and the final measurement on the frustrated
    32-spin glass, 4 rungs x 8 chains, 3 measured rounds after 8 burn-in
    rounds, every draw JAX makes from its keys fed to the port."""
    jplan, tplan, hp, a = glass
    betas0 = np.geomspace(0.3, 1.0, 4)
    kw = dict(n_iters=2, n_chains=8, n_rounds=3, sweeps_per_round=2)
    key = jax.random.PRNGKey(11)
    ref, ref0, ref1 = jpt.tune_pt_betas(key, jnp.asarray(hp), jnp.asarray(a), jplan, betas0, **kw)
    feeds = []
    for _ in range(kw["n_iters"] + 1):
        key, k = jax.random.split(key)
        feeds.append(_measurement_feed(k, jplan, 4, 8, 8, 3))
    ours, d0, d1 = tpt.tune_pt_betas(None, _t(hp), _t(a), tplan, betas0, **kw, feeds=feeds)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(d0.accept, ref0.accept, rtol=0, atol=1e-5)
    np.testing.assert_allclose(d1.accept, ref1.accept, rtol=0, atol=1e-5)
    assert ours[0] == betas0[0] and ours[-1] == 1.0 and (np.diff(ours) > 0).all()
    assert not np.allclose(ours, betas0)  # the glass moved the rungs


# ---------------------------------------------------------------------------
# the whole CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The port CLI chain's workdir."""
    return tmp_path_factory.mktemp("port_cli")


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    """A tiny model trained one epoch and saved by the port's Trainer."""
    from image_generation_tpu_torch.training.trainer import Trainer

    t = Trainer(TrainingConfig(QPU="Advantage2_prototype", N_LATENTS=32, DATASET_SIZE=64,
                               BATCH_SIZE=16, GIBBS_SWEEPS=2, NUM_READS=32, GIBBS_BURN_IN=2),
                device="cpu")
    t.train(1)
    return t.save(tmp_path_factory.mktemp("tiny") / "m", n_epochs=1)


def _run(capsys, w, *argv, tiny=True):
    cli.main(["--workdir", str(w), *argv] + (TINY if tiny else []))
    out = capsys.readouterr().out
    return (_names(w / "generated_json"), _names(w / "assets" / "model_diagram"), out)


def test_cli_chain_writes_the_jax_files(workdir, capsys):
    w = workdir
    gen, assets, out = _run(capsys, w, "train", "--name", "m", "--epochs", "2",
                            "--artifact-every", "2")
    assert "sampler=cuda_vmem device=cpu" in out and "epoch 2/2" in out
    # the metrics log and the last epoch's figures; the first epoch wrote none
    assert gen == {"loss_mse_epoch_1.json", "loss_total_epoch_1.json", "generated_epoch_1.json",
                   "reconstructed_epoch_1.json", "problem_details.json", "progress.json",
                   "metrics.jsonl"}
    assert assets == DIAGRAM and _names(w / "models" / "m") == MODEL_FILES
    details = json.loads((w / "generated_json" / "problem_details.json").read_text())
    assert details["Epoch"] == "2/2" and details["Sampler"] == "gibbs"
    assert [r["epoch"] for r in map(json.loads, (w / "generated_json" / "metrics.jsonl")
                                    .read_text().splitlines())] == [0, 1]
    params = json.loads((w / "models" / "m" / "parameters.json").read_text())
    assert (params["n_epochs"], params["n_latents"], params["qpu"]) == (2, 32,
                                                                       "Advantage2_prototype")
    assert len(params["physical_nodes"]) == 32

    gen, assets, out = _run(capsys, w, "generate", "--model", "m", "--sharpen")
    assert gen == GENERATED and assets == DIAGRAM and "generated 256 images" in out
    fig = json.loads((w / "generated_json" / "generated_epoch_0.json").read_text())
    z = np.asarray(fig["data"][0]["z"])
    assert z.shape == (16 * 34 + 2, 16 * 34 + 2) and set(np.unique(z)) <= set(range(256))
    details = json.loads((w / "generated_json" / "problem_details.json").read_text())
    assert set(details) == {"QPU", "Latents", "Couplers", "Reads", "Sampler", "Batch Size",
                            "Learning rate DVAE", "Learning rate GRBM"}

    gen, _, out = _run(capsys, w, "generate", "--model", "m", "--sampler", "pt",
                       "--num-reads", "16")
    assert gen == GENERATED and "generated 16 images" in out

    gen, assets, out = _run(capsys, w, "tune", "--model", "m", "--epochs", "1")
    assert gen == GENERATED | {"progress.json"} and assets == DIAGRAM
    tuned = w / "models" / "m_tuned_1_epochs"
    params = json.loads((tuned / "parameters.json").read_text())
    losses = json.loads((tuned / "losses.json").read_text())
    assert params["n_epochs"] == 3 and len(losses["mse_losses"]) == 3 * 4  # 2 + 1 epochs

    for f in (w / "assets" / "model_diagram").iterdir():
        f.unlink()
    gen, assets, out = _run(capsys, w, "refresh", "--model", "m")
    assert assets == DIAGRAM - {"latent_qpu.json"} and "refreshed model diagram" in out
    assert "generated_epoch_0.json" in gen  # refresh keeps the figures

    _run(capsys, w, "tune-pt", "--model", "m", "--iters", "1", "--chains", "8")
    pt = json.loads((w / "models" / "m" / "pt_betas.json").read_text())
    assert set(pt) == {"betas", "accept_before", "accept_after", "barrier_before",
                       "barrier_after", "recommended_num_betas"}
    b = np.asarray(pt["betas"])
    assert len(b) == 8 and b[-1] == 1.0 and (np.diff(b) > 0).all()

    _, _, out = _run(capsys, w, "models", tiny=False)
    assert out.splitlines() == ["m: qpu=Advantage2_prototype latents=32 epochs=2",
                                "m_tuned_1_epochs: qpu=Advantage2_prototype latents=32 epochs=3"]
    # the tuned ladder feeds back in as --pt-betas
    gen, _, out = _run(capsys, w, "generate", "--model", "m", "--pt-betas",
                       str(w / "models" / "m" / "pt_betas.json"), "--num-reads", "8")
    assert json.loads((w / "generated_json" / "problem_details.json").read_text())[
        "Sampler"] == "pt"


def test_cli_defaults_to_the_card(tmp_path):
    """No --platform: the card, which this CPU-only box does not have."""
    argv = ["--workdir", str(tmp_path), "train", "--name", "m"] + TINY[:-2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    with pytest.raises(SystemExit, match="--platform"):
        cli.main(argv + ["--platform", "tpu"])


def test_models_lists_nothing_in_an_empty_workdir(tmp_path, capsys):
    cli.main(["--workdir", str(tmp_path), "models"])
    assert capsys.readouterr().out.strip() == "(no saved models)"


def test_warm_generate_writes_the_cli_artifacts(tiny_model, tmp_path):
    """``WarmGenerator.generate``: the CLI generate's files, the trainer
    served before and after it from the same loaded weights."""
    w = WarmGenerator(tmp_path, device="cpu", config_overrides=dict(
        DATASET_SIZE=32, BATCH_SIZE=16, NUM_READS=16, GIBBS_BURN_IN=2, GIBBS_SWEEPS=2))
    model = tiny_model
    before = w.serve(model)["images"]
    assert w._trainer.state is None  # serving loads no train state
    w.generate(model, sharpen=True)
    assert _names(tmp_path / "generated_json") == GENERATED
    assert _names(tmp_path / "assets" / "model_diagram") == DIAGRAM
    details = json.loads((tmp_path / "generated_json" / "problem_details.json").read_text())
    assert "Learning rate DVAE" in details and w._trainer.state is not None
    assert w.serve(model)["images"].shape == before.shape == (16, 32, 32, 1)


def test_tune_ladder_measures_through_the_graph_sharded_layout(tiny_model):
    """``tune-pt``'s measurement on a (1, 2) graph-sharded mesh (two gloo
    ranks as threads): the trainer's sweeps and energies are the
    partitioned ones, each rank holds half the coupling's rows, and both
    ranks arrive at the same ascending ladder ending at 1.0;
    ``sample_sampleset`` there takes the graph-sharded branch."""
    from test_torch_graph_sharded import run_ranks
    from image_generation_tpu_torch.training.trainer import Trainer

    cfg = TrainingConfig(N_LATENTS=32, NUM_READS=8, BATCH_SIZE=16, DATASET_SIZE=32,
                         GIBBS_SWEEPS=2, GIBBS_BURN_IN=2, GRAPH_SHARDED="on",
                         PT_NUM_BETAS=4, COMPUTE_DTYPE="float32")

    def rank(mesh):
        t = Trainer(cfg, device="cpu", mesh=mesh)
        t.load(tiny_model)
        assert t.fns.sampler_impl.startswith("torch_graph_sharded")
        assert t.state.sampler_coupling.shape[0] == t.plan.n_pad // 2
        return cli.tune_ladder(t, seed=3, n_iters=1, n_chains=8), t.sample_sampleset(6)

    outs = run_ranks(2, rank)
    for (betas, d0, d1), ss in outs:
        np.testing.assert_array_equal(betas, outs[0][0][0])
        assert len(betas) == 4 and betas[-1] == 1.0 and (np.diff(betas) > 0).all()
        assert d1.accept.shape == (3,) and ((d1.accept > 0) & (d1.accept <= 1)).all()
        # generation samples through the partitioned sampler, energies edge-wise
        assert ss.info == {"sampler": "graph_sharded"} and ss.spins.shape == (6, 32)
        np.testing.assert_array_equal(ss.spins, outs[0][1].spins)
        assert np.isfinite(ss.energies).all()
