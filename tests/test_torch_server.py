"""Port parity: the web app (``app/server.py``) on the CPU.

Runs the contracts of ``tests/test_server.py``, ``test_app.py``,
``test_page_contract.py`` and the server's part of ``test_warm.py``
against the port's server, with the pass-through flags ``--platform cpu
--dataset-size 64 --batch-size 16 --sweeps 2``: the page byte-equal to the
JAX app's, the plain view, name validation and path traversal (400 / 404),
a tiny ``train`` job of the port's CLI (the job's argv names
``image_generation_tpu_torch.app.cli``) to ``done``, then ``generate``,
``tune`` and ``refresh`` jobs and ``cancel``; the render and topology
endpoints; under ``--warm-generate`` the in-process ``generate`` job and
``/api/generate_now`` (256 images, concurrent requests coalesced); a warm
server without ``--platform cpu`` and without a card refusing to start.
One plain server and one warm server serve the whole module.
"""

import json
import os
import re
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from image_generation_tpu.app import server as jserver
from image_generation_tpu_torch.app import cli, server
from image_generation_tpu_torch.app.files import RunFiles
from image_generation_tpu_torch.utils.grid import make_grid

EXTRA = ["--platform", "cpu", "--dataset-size", "64", "--batch-size", "16", "--sweeps", "2"]
TINY_MODEL = ["--qpu", "Advantage2_prototype", "--latents", "32"]
WARM_OVERRIDES = dict(DATASET_SIZE=64, BATCH_SIZE=16, GIBBS_SWEEPS=2, GIBBS_BURN_IN=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny tensor ops: one intra-op thread for this module (the suite
    runs six worker processes at once), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://localhost:{port}{path}", timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://localhost:{port}{path}", data=json.dumps(obj).encode(), method="POST"
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _serve(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv.server_address[1]


def _wait_job(port, deadline_s=600):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        _, body = _get(port, "/api/state")
        state = json.loads(body)
        if state["job"]["state"] in ("done", "failed"):
            return state
        time.sleep(0.5)
    raise AssertionError("job did not finish")


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """The server without warm serving.  Its CLI jobs inherit one intra-op
    thread: the suite runs six workers at once, and a job's default thread
    pool thrashes on the tiny model's tensors."""
    one_thread = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    saved = {k: os.environ.get(k) for k in one_thread}
    os.environ.update(one_thread)
    work = tmp_path_factory.mktemp("server_plain")
    srv = server.make_server(work, port=0, extra_cli=EXTRA)
    port = _serve(srv)
    yield srv, port, work
    srv.shutdown()
    srv.server_close()
    if srv.jobs.running():
        srv.jobs.cancel()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _clean(work):
    for d in ("generated_json", "assets", "models"):
        shutil.rmtree(work / d, ignore_errors=True)


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    work = tmp_path_factory.mktemp("server_warm")
    cli.main(["--workdir", str(work), "train", "--name", "warm_model", "--epochs", "1",
              *TINY_MODEL, *EXTRA])
    srv = server.make_server(work, port=0, extra_cli=EXTRA, warm_generate=True,
                             warm_overrides=WARM_OVERRIDES)
    port = _serve(srv)
    yield srv, port, work
    srv.shutdown()
    srv.server_close()


# ---------------------------------------------------------------- page

def test_page_is_byte_equal_to_the_jax_apps(plain):
    _, port, _ = plain
    assert server._render_page() == jserver._render_page()
    status, body = _get(port, "/")
    assert status == 200 and body == jserver._render_page().encode()


def test_page_and_state(plain):
    _, port, work = plain
    _clean(work)
    html = _get(port, "/")[1].decode()
    assert "ML Image Generation" in html and "#074C91" in html and "Advantage2_system1" in html
    for ph in ("{title}", "{css}", "{qpu_options}", "{theme}", "{theme2}"):
        assert ph not in html
    assert "validateName" in html and "Epochs Completed" in html and "refresh_model" in html
    assert html.count("<details") == html.count("</details>") == 2
    st = json.loads(_get(port, "/api/state")[1])
    assert st["latest_epoch"] is None and st["job"]["state"] in ("idle", "done")


def test_plain_view_idle(plain):
    _, port, work = plain
    _clean(work)
    status, body = _get(port, "/plain")
    html = body.decode()
    assert status == 200 and "<script" not in html and 'http-equiv="refresh"' in html
    assert "job: " in html and 'rel="icon" href="/favicon.ico"' in html


def test_favicon_and_default_output_placeholder(plain):
    import struct

    _, port, work = plain
    _clean(work)
    status, body = _get(port, "/favicon.ico")
    assert status == 200 and struct.unpack("<HHH", body[:6]) == (0, 1, 1)
    assert body == (server.Path(server.__file__).parent / "static" / "favicon.ico").read_bytes()
    status, body = _get(port, "/assets/model_diagram/step_5_output_default.png")
    assert status == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
    d = work / "assets" / "model_diagram"
    d.mkdir(parents=True)
    (d / "step_5_output_default.png").write_bytes(b"\x89PNG\r\n\x1a\nxx")  # a workdir copy wins
    assert _get(port, "/assets/model_diagram/step_5_output_default.png")[1].endswith(b"xx")
    _clean(work)


# ---------------------------------------------------------------- page contract

def _page_parts():
    full = server._render_page()
    m = re.search(r"<script>(.*)</script>", full, re.S)
    return full[: m.start()] + full[m.end():], m.group(1)


def test_page_contract_ids_handlers_and_tabs():
    html, script = _page_parts()
    ids = set(re.findall(r'id="([\w-]+)"', html))
    looked_up = set(re.findall(r"\$\('([\w-]+)'\)", script))
    looked_up |= set(re.findall(r"getElementById\('([\w-]+)'\)", script + html))
    assert looked_up <= ids
    for prefix, names in (("tab-", ("train", "generate")),
                          ("res-", ("generated", "reconstructed", "loss", "diagram")),
                          ("d", ("1", "2", "4", "5"))):
        assert all(prefix + n in ids for n in names)
    handlers = set(re.findall(r'on(?:click|input)="(\w+)\(', html))
    assert handlers <= set(re.findall(r"function (\w+)\(", script))


def test_every_fetched_endpoint_is_routed(plain):
    """GET / POST every URL the page's script uses against the port's
    server: none hits the unrouted-path marker; planted fixtures give 200."""
    _, port, work = plain
    _clean(work)
    _, script = _page_parts()
    rf = RunFiles(work)
    grid = np.zeros((4, 4, 1))
    rf.write_epoch(0, grid, grid, [1.0, 0.5], [2.0, 1.0])
    diagram = work / "assets" / "model_diagram"
    diagram.mkdir(parents=True, exist_ok=True)
    (diagram / "latent_encoded.json").write_text(json.dumps([1.0, -1.0, 1.0]))
    stages = {"1": "input", "2": "encode", "4": "decode", "5": "output"}
    for k, stage in stages.items():
        (diagram / f"step_{k}_{stage}.png").write_bytes(b"\x89PNG fake")
    posts = {"/api/train", "/api/generate", "/api/tune", "/api/cancel", "/api/refresh_model"}
    must_200 = ("/api/render/generated/", "/api/render/reconstructed/", "/api/render/loss_mse/",
                "/api/render/loss_total/", "/api/render/latent_strip", "/assets/")
    urls = set(re.findall(r"'(/(?:api|assets)/[^']*)'", script))
    urls |= set(re.findall(r"`(/(?:api|assets)/[^`]*)`", script))
    assert any("step_${k}_" in u for u in urls)
    urls = {u for u in urls if "step_${k}_" not in u}
    urls |= {f"/assets/model_diagram/step_{k}_{s}.png" for k, s in stages.items()}
    assert len(urls) >= 14
    for raw in sorted(urls):
        url = re.sub(r"\$\{(?:model|[\w.]*\bvalue)[^}]*\}", "no_such_model", raw)
        url = re.sub(r"\$\{[^}]*\}", "0", url)
        if raw in posts:
            if raw == "/api/train":
                continue  # would start a job; routed in test_train_job_lifecycle
            status, body = _post(port, url, {})
        else:
            status, raw_body = _get(port, url)
            try:
                body = json.loads(raw_body)
            except (json.JSONDecodeError, UnicodeDecodeError):
                body = {}
        body = body if isinstance(body, dict) else {}
        if url.split("?")[0].startswith(must_200):
            assert status == 200, url
        elif "no_such_model" in url:
            assert (status, body.get("error")) in ((404, "unknown model"),
                                                   (400, "invalid model name")), url
        else:
            assert (status, body.get("error", "")) != (404, "not found"), url
    _clean(work)


# ---------------------------------------------------------------- API

def test_models_figure_and_render_endpoints(plain):
    _, port, work = plain
    _clean(work)
    assert json.loads(_get(port, "/api/models")[1]) == []
    assert _get(port, "/api/figure/generated/0")[0] == 404
    assert _get(port, "/api/figure/generated/notanumber")[0] == 404
    assert _get(port, "/api/render/generated/notanumber.png")[0] == 404
    assert _get(port, "/api/render/generated/0.png")[0] == 404
    assert _get(port, "/api/render/latent_strip.svg")[0] == 404
    rf = RunFiles(work)
    rf.write_epoch(0, np.zeros((4, 4, 1)), np.ones((4, 4, 1)), [1.0, 0.5], [2.0, 1.5])
    assert json.loads(_get(port, "/api/figure/loss_mse/0")[1])["data"][0]["y"] == [1.0, 0.5]
    status, body = _get(port, "/api/render/generated/0.png")
    assert status == 200 and body[:4] == b"\x89PNG"
    status, body = _get(port, "/api/render/loss_total/0.svg")
    assert status == 200 and body.startswith(b"<svg") and b"polyline" in body
    rf.write_latent_encoded([1.0, -1.0, 1.0, 1.0, -1.0, 1.0])
    status, body = _get(port, "/api/render/latent_strip.svg")
    assert status == 200 and body.count(b"<rect") == 6
    assert json.loads(_get(port, "/api/problem_details_html")[1]) == {"html": ""}
    rf.write_problem_details("Advantage2_system1", 32, 100, 64, "gibbs", extra={"Epoch": "1/2"})
    html = json.loads(_get(port, "/api/problem_details_html")[1])["html"]
    assert html.startswith('<table class="problem-details-table">') and "<td>1/2</td>" in html
    _clean(work)


def test_model_data_html_endpoint(plain):
    _, port, work = plain
    _clean(work)
    assert _get(port, "/api/model_data_html/nope")[0] == 404
    assert _get(port, "/api/model_data_html/..")[0] == 404
    mdir = work / "models" / "card_model"
    mdir.mkdir(parents=True)
    (mdir / "parameters.json").write_text(json.dumps({
        "n_latents": 64, "n_epochs": 7, "qpu": "Advantage2_system1", "batch_size": 128,
        "data_source": "sklearn-digits-upsampled"}))
    html = json.loads(_get(port, "/api/model_data_html/card_model")[1])["html"]
    for frag in ("QPU", "Advantage2_system1", "Epochs", "7", "Latents", "64", "Batch Size",
                 "128", "sklearn-digits-upsampled", 'class="model-details"'):
        assert frag in html
    _clean(work)


def test_name_validation_and_traversal(plain):
    _, port, _ = plain
    assert server.valid_name("my_model-2")
    for bad in ("", "a/b", "../escape", "/abs/path", "name with space", None, 42):
        assert not server.valid_name(bad)
    for bad in ("../outside", "/etc", "a/b", "..", ""):
        for ep in ("/api/generate", "/api/tune", "/api/refresh_model"):
            status, _ = _post(port, ep, {"model": bad})
            assert status == 400, (ep, bad)
    assert _post(port, "/api/train", {"name": "../evil"})[0] == 400
    assert _get(port, "/api/topology/../x/encoded")[0] == 404
    assert _get(port, "/assets/../../../etc/passwd")[0] == 404
    assert _post(port, "/api/generate", {"model": "nope"})[0] == 404
    assert _post(port, "/api/cancel", {})[1] == {"cancelled": False}


def test_generate_now_requires_warm(plain):
    _, port, _ = plain
    status, resp = _post(port, "/api/generate_now", {"model": "whatever"})
    assert status == 400 and "warm serving disabled" in resp["error"]


def test_train_job_lifecycle(plain):
    """train → done (the port's CLI in a subprocess) → the figures, the
    rendered endpoints and the topology; then generate, tune and refresh
    jobs to done, and a started train job cancelled."""
    srv, port, work = plain
    _clean(work)
    status, resp = _post(port, "/api/train", {
        "name": "webrun", "qpu": "Advantage2_prototype", "latents": 32, "epochs": 1})
    assert status == 200 and resp["started"]
    assert srv.jobs.proc.args[:3] == [server.sys.executable, "-m",
                                      "image_generation_tpu_torch.app.cli"]
    assert _post(port, "/api/train", {"name": "x"})[0] == 409  # one job at a time
    state = _wait_job(port)
    assert state["job"] == {"state": "done", "kind": "train", "rc": 0}, state
    assert state["latest_epoch"] == 0 and state["progress"]["total"] == 1
    assert "webrun" in [m["name"] for m in json.loads(_get(port, "/api/models")[1])]
    details = json.loads(_get(port, "/api/problem_details")[1])
    assert details["Epoch"] == "1/1" and "Learning rate DVAE" in details
    plain_html = _get(port, "/plain")[1].decode()
    assert "job: done" in plain_html and "Epoch 0" in plain_html
    assert 'class="model-details"' in plain_html
    srcs = re.findall(r'src="([^"]+)"', plain_html)
    assert len(srcs) == 4
    for src in srcs:
        s, b = _get(port, src)
        assert s == 200 and len(b) > 100, src
    status, body = _get(port, "/api/render/topology/webrun/encoded.svg")
    assert status == 200 and body.count(b"<circle") == 32
    fig = json.loads(_get(port, "/api/topology/webrun/qpu")[1])
    assert len(fig["data"][1]["x"]) == 32

    for path, body, kind in (("/api/generate", {"model": "webrun", "sharpen": True}, "generate"),
                             ("/api/tune", {"model": "webrun", "epochs": 1}, "tune"),
                             ("/api/refresh_model", {"model": "webrun"}, "refresh")):
        status, resp = _post(port, path, body)
        assert status == 200 and resp["started"], path
        state = _wait_job(port)
        assert state["job"] == {"state": "done", "kind": kind, "rc": 0}, state
    assert (work / "models" / "webrun_tuned_1_epochs" / "dvae.pth").is_file()
    assert (work / "assets" / "model_diagram" / "latent_encoded.json").is_file()

    status, resp = _post(port, "/api/train", {"name": "cancelled", "epochs": 1,
                                              "qpu": "Advantage2_prototype", "latents": 32})
    assert resp["started"]
    assert _post(port, "/api/cancel", {})[1] == {"cancelled": True}
    state = _wait_job(port)
    assert state["job"]["state"] == "failed" and state["job"]["rc"] != 0


# ---------------------------------------------------------------- warm serving

def test_warm_generate_job(warm):
    """/api/generate runs in-process on the resident trainer: artifacts
    written, the job gate kept, cancel False for a thread job; a corrupt
    model fails the job with its error and the manager serves again."""
    _, port, work = warm

    def wait():
        deadline = time.time() + 240
        while time.time() < deadline:
            job = json.loads(_get(port, "/api/state")[1])["job"]
            if job["state"] in ("done", "failed"):
                return job
            assert _post(port, "/api/cancel", {})[1] == {"cancelled": False}
            time.sleep(0.3)
        raise AssertionError("warm job did not finish")

    status, resp = _post(port, "/api/generate", {"model": "warm_model"})
    assert status == 200 and resp["started"]
    assert wait() == {"state": "done", "kind": "generate"}
    assert (work / "generated_json" / "generated_epoch_0.json").exists()
    assert (work / "assets" / "model_diagram" / "latent_qpu.json").exists()
    bad = work / "models" / "bad"
    bad.mkdir(exist_ok=True)
    (bad / "dvae.pth").write_bytes(b"not a checkpoint")
    assert _post(port, "/api/generate", {"model": "bad"})[1]["started"]
    job = wait()
    assert job["state"] == "failed" and job["error"]
    assert _post(port, "/api/generate", {"model": "warm_model"})[1]["started"]
    assert wait()["state"] == "done"
    shutil.rmtree(bad)


def test_generate_now_serves_256_images_and_coalesces(warm):
    srv, port, work = warm
    assert _post(port, "/api/generate_now", {"model": "nope"})[0] == 404
    gen_dir = work / "generated_json"
    before = set(gen_dir.rglob("*"))
    stats0 = dict(srv.warm.stats)
    status, resp = _post(port, "/api/generate_now", {"model": "warm_model"})
    assert status == 200 and resp["batched"] == 1 and resp["latency_ms"] > 0
    z = np.asarray(resp["figure"]["data"][0]["z"])
    assert z.shape == make_grid(np.zeros((256, 32, 32, 1)), nrow=16).shape[:2]
    assert resp["figure"]["data"][0]["zmax"] == 255 and 0 <= z.min() and z.max() <= 255
    assert set(gen_dir.rglob("*")) == before  # read-only on the workdir
    assert json.loads(_get(port, "/api/state")[1])["job"]["state"] != "running"

    n = 5
    results = [None] * n
    coal = srv.warm._coalescer
    orig_run, gate = coal._run_group, threading.Event()

    def gated_run(group):
        gate.wait(120)
        orig_run(group)

    coal._run_group = gated_run
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, _post(port, "/api/generate_now", {"model": "warm_model"}))) for i in range(n)]
    for th in threads:
        th.start()
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            with coal._cv:
                if coal._pending:
                    break
            time.sleep(0.01)
        else:
            pytest.fail("no request ever queued behind the leader")
    finally:
        gate.set()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    coal._run_group = orig_run
    assert all(r[0] == 200 for r in results)
    stats = srv.warm.stats
    assert stats["served"] - stats0["served"] == 1 + n
    assert stats["dispatches"] - stats0["dispatches"] < 1 + n
    assert max(r[1]["batched"] for r in results) > 1


def test_warm_serving_honours_extra_cli(tmp_path):
    srv = server.make_server(
        tmp_path, port=0, warm_generate=True,
        extra_cli=["--sampler-matmul-dtype", "int8", "--dataset-size", "32", "--platform", "cpu"],
        warm_overrides={"DATASET_SIZE": 64},  # explicit overrides win
    )
    try:
        assert srv.warm.config_overrides["SAMPLER_MATMUL_DTYPE"] == "int8"
        assert srv.warm.config_overrides["DATASET_SIZE"] == 64
        assert srv.warm.device.type == "cpu" and srv.warm.mesh == "auto"
    finally:
        srv.server_close()


def test_warm_server_with_params_builds_the_clis_config(warm, tmp_path, monkeypatch):
    """``--params`` reaches the warm trainer as the CLI's ``_build_trainer``
    applies it: the YAML under the flag overrides."""
    _, _, work = warm
    params = tmp_path / "params.yaml"
    params.write_text("GIBBS_SWEEPS: 3\nNUM_READS: 48\nLEARNING_RATE_DVAE: 1.0e-3\n"
                      "BATCH_SIZE: 8\n")
    extra = ["--params", str(params), "--batch-size", "16", "--platform", "cpu"]
    srv = server.make_server(work, port=0, extra_cli=extra, warm_generate=True)
    try:
        model = work / "models" / "warm_model"
        served = srv.warm._trainer_for(model).config
        args = cli.build_parser().parse_args(["generate", "--model", str(model), *extra])
        t = cli._build_trainer(args, for_load=True, serving_model_dir=model)
        t.load(model, train_state=False)
        assert served == t.config
        assert (served.GIBBS_SWEEPS, served.NUM_READS, served.BATCH_SIZE) == (3, 48, 16)
    finally:
        srv.server_close()
    # a mesh the port cannot run: more ranks than cards (one card a rank)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--mesh 2x2 asks for 4 ranks.* 1 card"):
        server.make_server(work, port=0, extra_cli=["--mesh", "2x2"], warm_generate=True)


def test_warm_server_without_a_card_fails_at_startup(tmp_path):
    """The default device is the card: with none visible and no
    ``--platform cpu``, ``--warm-generate`` refuses to start."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device starts")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.make_server(tmp_path, port=0, warm_generate=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main(["--warm-generate", "--port", "0", "--workdir", str(tmp_path)])
