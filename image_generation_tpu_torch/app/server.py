"""Web application: the demo's page, its JSON API and its background jobs.

Port of ``image_generation_tpu/app/server.py`` on the standard library
(``ThreadingHTTPServer``; no web framework):

  * one self-contained HTML page (inline CSS from the theme colour), the
    same bytes as the JAX app's page;
  * every figure rendered server-side (``app/render.py``): the page's
    script only swaps ``<img>`` sources and ``innerHTML``;
  * train / generate / tune / refresh run as separate OS processes of the
    port's CLI (``python -m image_generation_tpu_torch.app.cli``), each in
    a session of its own; the CLI starts a rank on every card its
    ``--mesh`` asks for ('auto': every visible card), and ``/api/cancel``
    stops the job and every rank of it;
  * with ``--warm-generate``, ``POST /api/generate`` and the coalescing
    ``POST /api/generate_now`` are served in-process by a resident
    ``WarmGenerator`` on the device the pass-through flags name: the card
    unless ``--platform cpu``; with no card visible the server does not
    start.  Where ``--mesh`` asks for several ranks ('auto': every visible
    card) the server is rank 0 of a world with a follower process on each
    other card, and every dispatch samples on every card
    (``app.warm.make_warm_generator``); shutting the server down stops
    them.  A request that fails on the card answers 500 (``generate_now``)
    or ``failed`` (``/api/state``); it is never served on the CPU instead,
    nor on fewer cards;
  * the page polls ``/api/...`` every 500 ms, reading the ``generated_json/``
    files the jobs write;
  * model and file names must match ``^[\\w-]+$`` (400 otherwise), which
    also closes path traversal through POST bodies;
  * binds 127.0.0.1 by default; ``--host 0.0.0.0`` exposes it.

Run:  python -m image_generation_tpu_torch.app.server --warm-generate [--port 8050]
      [--workdir W] [pass-through CLI flags, e.g. --platform cpu]
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import urlparse

from image_generation_tpu_torch.app import ui_config
from image_generation_tpu_torch.app.files import RunFiles, list_models
from image_generation_tpu_torch.utils.topology import QPU_TOPOLOGIES

__all__ = ["make_server", "main", "valid_name"]

_NAME_RE = re.compile(r"^[\w-]+$")  # reference demo_callbacks.py:457


def valid_name(name) -> bool:
    """Model/file-name validation — a-z A-Z 0-9 _ - only (the reference's
    ``file_name_validation`` pattern, demo_callbacks.py:441-457).  Rejects
    path separators, '..', absolute paths, and empty names, so a validated
    name can be safely joined under workdir/models."""
    return isinstance(name, str) and bool(_NAME_RE.match(name))


def _descendants(pid: int) -> list:
    """The pids of every process below ``pid``, from ``/proc`` (none where
    it cannot be read)."""
    children: dict = {}
    try:
        entries = os.listdir("/proc")
    except OSError:
        return []
    for d in entries:
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(d))
    out, todo = [], [pid]
    while todo:
        for c in children.get(todo.pop(), []):
            out.append(c)
            todo.append(c)
    return out


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie, which holds no card, does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def _stop_job(proc: subprocess.Popen, ranks: list, grace_s: float = 10.0) -> None:
    """After SIGTERM to a job's group: kill, after ``grace_s``, whatever of
    the job and its ranks still runs (the ranks sit in sessions of their
    own, where the group's signal does not reach; the CLI stops them on
    SIGTERM)."""
    deadline = time.monotonic() + grace_s
    try:
        proc.wait(timeout=grace_s)
    except subprocess.TimeoutExpired:
        pass
    while any(_alive(p) for p in ranks) and time.monotonic() < deadline:
        time.sleep(0.1)
    for pid in ([proc.pid] if proc.poll() is None else []) + [p for p in ranks if _alive(p)]:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    proc.poll()


class JobManager:
    """One background job at a time (the reference's single background
    callback + cancel semantics).  Two job shapes behind one status
    protocol: OS subprocesses (the CLI — cancellable, the reference's
    ``background=True`` model) and in-process daemon threads (warm
    generation serving — not interruptible once dispatched to the device,
    so ``cancel`` reports False for them)."""

    def __init__(self, workdir: Path):
        self.workdir = Path(workdir)
        self.proc: subprocess.Popen | None = None
        self.kind = None
        self.lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._thread_state = None  # "done" | "failed" after the thread ends
        self._thread_error = None

    def running(self) -> bool:
        if self.proc is not None and self.proc.poll() is None:
            return True
        return self._thread is not None and self._thread.is_alive()

    def start(self, kind: str, cli_args: list) -> bool:
        with self.lock:
            if self.running():
                return False
            cmd = [sys.executable, "-m", "image_generation_tpu_torch.app.cli",
                   "--workdir", str(self.workdir)] + cli_args
            # the job runs with the workdir as cwd; make the package
            # importable from there regardless of installation
            pkg_root = str(Path(__file__).resolve().parents[2])
            # a job starts its own ranks: it is no rank of this server's world
            env = {k: v for k, v in os.environ.items()
                   if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                                "MASTER_PORT")}
            env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
            self._thread = self._thread_state = self._thread_error = None
            self.proc = subprocess.Popen(cmd, cwd=str(self.workdir), env=env,
                                         start_new_session=True)
            self.kind = kind
            return True

    def start_call(self, kind: str, fn) -> bool:
        """Run ``fn()`` on a daemon thread under the same one-job gate."""
        with self.lock:
            if self.running():
                return False
            self.proc = None
            self.kind = kind
            self._thread_state, self._thread_error = "running", None

            def run():
                try:
                    fn()
                    self._thread_state = "done"
                except Exception as e:  # surfaced via /api/state
                    self._thread_error = f"{type(e).__name__}: {e}"
                    self._thread_state = "failed"

            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
            return True

    def cancel(self) -> bool:
        """Stop the running CLI job and every rank it started: SIGTERM to
        the job's session group (the CLI stops its ranks on it), then,
        after a grace period, SIGKILL to whatever of them still runs."""
        with self.lock:
            if self.proc is None or self.proc.poll() is not None:
                return False  # idle, finished, or an uninterruptible thread job
            ranks = _descendants(self.proc.pid)
            try:
                os.killpg(self.proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
            threading.Thread(target=_stop_job, args=(self.proc, ranks), daemon=True).start()
            return True

    def status(self) -> dict:
        if self._thread is not None:
            if self._thread.is_alive():
                return {"state": "running", "kind": self.kind}
            out = {"state": self._thread_state or "done", "kind": self.kind}
            if self._thread_error:
                out["error"] = self._thread_error
            return out
        if self.proc is None:
            return {"state": "idle"}
        rc = self.proc.poll()
        if rc is None:
            return {"state": "running", "kind": self.kind}
        return {"state": "done" if rc == 0 else "failed", "kind": self.kind, "rc": rc}


def _theme_css() -> str:
    """The reference generates assets/__generated_theme.css from THEME_COLOR
    (app.py:76-83); same idea, inlined."""
    return f"""
:root {{ --theme: {ui_config.THEME_COLOR}; --theme2: {ui_config.THEME_COLOR_SECONDARY}; }}
body {{ font-family: system-ui, sans-serif; margin: 0; background: #f5f7fa; }}
header {{ background: var(--theme); color: #fff; padding: 14px 24px; }}
header h1 {{ margin: 0; font-size: 20px; }}
.wrap {{ display: flex; gap: 16px; padding: 16px; }}
.panel {{ background: #fff; border-radius: 8px; padding: 16px; box-shadow: 0 1px 3px rgba(0,0,0,.12); }}
.settings {{ width: 320px; flex-shrink: 0; }}
.results {{ flex: 1; min-width: 0; }}
label {{ display: block; margin: 10px 0 2px; font-size: 13px; color: #333; }}
input, select {{ width: 100%; box-sizing: border-box; padding: 6px; }}
input.invalid {{ border: 1px solid #c0392b; outline: none; }}
/* theme-colored sliders (reference assets/_slider.css: theme-secondary
   track + handle, brightness shift on hover/drag) */
input[type=range] {{ accent-color: var(--theme2); padding: 0; }}
input[type=range]::-webkit-slider-thumb {{ transition: filter .1s ease-in-out; }}
input[type=range]:hover::-webkit-slider-thumb,
input[type=range]:active::-webkit-slider-thumb {{ filter: brightness(80%); }}
input[type=range]::-moz-range-thumb {{ border-color: var(--theme2);
  transition: filter .1s ease-in-out; }}
input[type=range]::-moz-range-track {{ background-color: var(--theme2); }}
.help-text {{ color: #c0392b; font-size: 12px; margin-top: 2px; }}
button {{ background: var(--theme); color: #fff; border: 0; border-radius: 4px;
         padding: 10px 18px; margin-top: 14px; cursor: pointer; }}
button.secondary {{ background: var(--theme2); }}
button:disabled {{ background: #aaa; }}
/* top-rounded selected tab sitting on a theme-secondary rule (reference
   assets/_tabs.css: .tab-container / div.tab.tab--selected) */
.tabs {{ display: flex; gap: 4px; margin-bottom: 10px;
  border-bottom: 3px solid var(--theme2); }}
.tabs div {{ padding: 8px 14px; cursor: pointer; margin-bottom: -3px;
  border: 3px solid transparent; border-bottom: none;
  border-radius: 6px 6px 0 0; }}
.tabs div.active {{ border-color: var(--theme2); background: #fff;
  cursor: default; font-weight: 600; box-shadow: 0 6px 0 -3px #fff; }}
/* collapsible sections (reference assets/_collapse.css:
   left-column-collapse / details-collapse, 0.6s ease-in-out) */
details.collapse > summary {{ cursor: pointer; font-weight: 600;
  font-size: 13px; color: #333; margin: 4px 0; user-select: none; }}
details.collapse > .collapse-body {{ overflow: hidden; }}
details.collapse[open] > .collapse-body {{
  animation: expand-collapse .6s ease-in-out; }}
@keyframes expand-collapse {{
  from {{ max-height: 0; opacity: .3; }}
  to {{ max-height: 100vh; opacity: 1; }} }}
progress {{ width: 100%; height: 14px; }}
.progress-caption {{ font-size: 12px; color: #333; }}
img.fig {{ image-rendering: pixelated; width: 100%; background: #fff; border: 1px solid #eee; }}
img.plot {{ width: 100%; background: #fff; border: 1px solid #eee; }}
.status {{ font-size: 12px; color: #666; margin-top: 8px; }}
img.diagram {{ width: 120px; image-rendering: pixelated; border: 1px solid #ddd; margin: 2px; }}
table.problem-details-table {{ border-collapse: collapse; font-size: 12px; margin-top: 8px; }}
table.problem-details-table th, table.problem-details-table td
  {{ border: 1px solid #ddd; padding: 4px 8px; text-align: left; }}
table.problem-details-table th {{ background: #f0f4f8; }}
.model-details {{ display: flex; gap: 18px; font-size: 12px; color: #333;
  background: #f7f9fb; border: 1px solid #e3e8ee; border-radius: 6px;
  padding: 2px 10px; margin-top: 8px; }}
.model-details p {{ margin: 4px 0; }}
.data-origin {{ font-size: 11px; color: #666; margin-top: 2px; }}
"""


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title>
<link rel="icon" href="/favicon.ico"><style>{css}</style></head>
<body>
<noscript><div style="padding:8px;background:#fff3cd">JavaScript is disabled —
use the <a href="/plain">server-rendered status view</a> (auto-refreshing, no
scripts).</div></noscript>
<header><h1>{header}</h1><div style="font-size:12px">{description}</div></header>
<div class="wrap">
  <div class="panel settings">
    <details class="collapse" id="settings-collapse" open>
    <summary>Settings</summary>
    <div class="collapse-body">
    <div class="tabs" id="settings-tabs">
      <div class="active" data-tab="train">Train</div>
      <div data-tab="generate">Generate</div>
    </div>
    <div id="tab-train">
      <label title="Directory name the trained model is saved under (models/&lt;name&gt;)">Model name</label>
      <input id="name" value="tpu_model" oninput="validateName()">
      <div class="help-text" id="name-help" style="display:none">
        File name must only contain letters, numbers, hyphens and underscores.</div>
      <label title="Coupling-graph family for the GRBM latent prior; the reference samples this hardware, here an on-device Gibbs sampler runs the same graph">QPU topology</label><select id="qpu">{qpu_options}</select>
      <label title="Number of ±1 spin latent variables = nodes of the GRBM subgraph">Latents: <span id="latents-val">{lat_val}</span></label>
      <input type="range" id="latents" min="{lat_min}" max="{lat_max}" step="{lat_step}" value="{lat_val}"
             oninput="document.getElementById('latents-val').innerText=this.value">
      <label title="Passes over the training set (468 batches of 128 each at full size)">Epochs: <span id="epochs-val">{ep_val}</span></label>
      <input type="range" id="epochs" min="{ep_min}" max="{ep_max}" value="{ep_val}"
             oninput="document.getElementById('epochs-val').innerText=this.value">
      <button id="train-btn" onclick="startTrain()">Train</button>
    </div>
    <div id="tab-generate" style="display:none">
      <label>Model</label><select id="model" onchange="modelChanged()"></select>
      <div id="model-data"></div>
      <label title="Binarize bright/dark pixels above 0.6 / below 0.4, keep mid-range">
        <input type="checkbox" id="sharpen" style="width:auto"> Sharpen output</label>
      <label>Tune epochs</label><input type="number" id="tune-epochs" value="5" min="1">
      <button id="gen-btn" onclick="startGenerate()">Generate</button>
      <button class="secondary" onclick="startTune()">Tune Parameters</button>
    </div>
    </div>
    </details>
    <button class="secondary" id="cancel-btn" onclick="cancelJob()" disabled>Cancel</button>
    <progress id="prog" value="0" max="1"></progress>
    <div class="progress-caption" id="prog-epoch"></div>
    <div class="progress-caption" id="prog-batch"></div>
    <div class="status" id="status">idle</div>
  </div>
  <div class="panel results">
    <div class="tabs" id="result-tabs">
      <div class="active" data-tab="generated">Generated Images</div>
      <div data-tab="reconstructed">Reconstructions</div>
      <div data-tab="loss">Loss Graphs</div>
      <div data-tab="diagram">Model Diagram</div>
    </div>
    <div id="res-generated"><img class="fig" id="img-generated" alt="generated images"></div>
    <div id="res-reconstructed" style="display:none"><img class="fig" id="img-reconstructed" alt="reconstructions"></div>
    <div id="res-loss" style="display:none">
      <img class="plot" id="img-mse" alt="MSE loss"><img class="plot" id="img-total" alt="total loss">
    </div>
    <details class="collapse" id="problem-details-collapse" open>
    <summary>Problem details</summary>
    <div class="collapse-body"><div id="problem-details"></div></div>
    </details>
    <div id="res-diagram" style="display:none">
      <div>
        <img class="diagram" id="d1" alt="input"> →
        <img class="diagram" id="d2" alt="encode"> →
        <img id="latent-strip" alt="latent ±1 vector" style="height:44px;vertical-align:middle"> →
        <img class="diagram" id="d4" alt="decode"> →
        <img class="diagram" id="d5" alt="output"
             src="/assets/model_diagram/step_5_output_default.png">
      </div>
      <div style="display:flex;gap:8px;margin-top:8px">
        <div style="flex:1"><div style="font-size:12px">Encoded latent on QPU graph</div>
          <img class="plot" id="topo-encoded" style="height:340px" alt="encoded latent graph"></div>
        <div style="flex:1"><div style="font-size:12px">Sampled latent on QPU graph</div>
          <img class="plot" id="topo-qpu" style="height:340px" alt="sampled latent graph"></div>
      </div>
    </div>
  </div>
</div>
<script>
let lastEpoch = -1, lastProgress = 0, lastDrawn = -1, lastJobState = '';
function $(id) {{ return document.getElementById(id); }}
function tabs(groupId) {{
  const g = $(groupId);
  g.querySelectorAll('div').forEach(t => t.onclick = () => {{
    g.querySelectorAll('div').forEach(x => x.classList.remove('active'));
    t.classList.add('active');
    g === $('settings-tabs')
      ? ['train','generate'].forEach(n => $('tab-'+n).style.display = (n===t.dataset.tab)?'':'none')
      : ['generated','reconstructed','loss','diagram'].forEach(n => $('res-'+n).style.display = (n===t.dataset.tab)?'':'none');
  }});
}}
tabs('settings-tabs'); tabs('result-tabs');
function validateName() {{
  const ok = /^[\\w-]+$/.test($('name').value);
  $('train-btn').disabled = !ok;
  $('name-help').style.display = ok ? 'none' : '';
  $('name').classList.toggle('invalid', !ok);
  return ok;
}}
async function fetchJSON(url, opts) {{
  const r = await fetch(url, opts); if (!r.ok) return null;
  return await r.json();
}}
function setImg(id, url) {{
  const img = $(id); const probe = new Image();
  probe.onload = () => {{ img.src = url; }};   // only swap when it exists
  probe.src = url;
}}
async function refreshModels() {{
  const models = await fetchJSON('/api/models');
  const sel = $('model'); const cur = sel.value; sel.innerHTML = '';
  (models || []).forEach(m => {{
    const o = document.createElement('option'); o.value = o.text = m.name; sel.add(o);
  }});
  if (cur) sel.value = cur;
  refreshModelData();
}}
async function refreshModelData() {{
  // the selected model's QPU/Epochs/Latents/Batch card (server-rendered;
  // names are ^[\\w-]+$-validated, so the path needs no URI escaping)
  const model = $('model').value;
  if (!model) {{ $('model-data').innerHTML = ''; return; }}
  const md = await fetchJSON(`/api/model_data_html/${{model}}`);
  if (md && md.html !== undefined) $('model-data').innerHTML = md.html;
}}
function refreshDiagram(bust) {{
  ['1','2','4','5'].forEach(k => setImg('d' + k,
    `/assets/model_diagram/step_${{k}}_` +
    ({{'1':'input','2':'encode','4':'decode','5':'output'}})[k] + `.png?e=${{bust}}`));
  setImg('latent-strip', `/api/render/latent_strip.svg?e=${{bust}}`);
  const model = $('model').value || $('name').value;
  setImg('topo-encoded', `/api/render/topology/${{model}}/encoded.svg?e=${{bust}}`);
  setImg('topo-qpu', `/api/render/topology/${{model}}/qpu.svg?e=${{bust}}`);
}}
async function modelChanged() {{
  // the reference regenerates the model diagram + topology figures AND the
  // model-data card whenever the dropdown changes (check_qpu_and_update_model)
  // — fill the card, then run the cheap refresh job; the poller picks up
  // the new assets
  refreshModelData();
  await fetchJSON('/api/refresh_model', {{method: 'POST',
    body: JSON.stringify({{model: $('model').value}})}});
}}
async function poll() {{
  const st = await fetchJSON('/api/state');
  if (!st) return;
  $('status').innerText = st.job.state + (st.job.kind ? ' ('+st.job.kind+')' : '');
  $('train-btn').disabled = st.job.state === 'running' || !validateName();
  $('gen-btn').disabled = st.job.state === 'running';
  $('cancel-btn').disabled = st.job.state !== 'running';
  if (st.progress) {{
    $('prog').value = st.progress.step; $('prog').max = st.progress.total;
    $('prog-epoch').innerText = `Epochs Completed: ${{st.progress.step}}/${{st.progress.total}}`;
    $('prog-batch').innerText = (st.progress.batch !== undefined)
      ? `Batch: ${{st.progress.batch}}/${{st.progress.n_batches}}` : '';
  }}
  const pd = await fetchJSON('/api/problem_details_html');
  if (pd && pd.html) $('problem-details').innerHTML = pd.html;
  if (st.job.state === 'running' && st.job.kind === 'refresh') lastProgress++;
  // any job finishing writes its last assets right before exit — redraw
  // once more on the running→done transition so the final images land
  if (lastJobState === 'running' && st.job.state !== 'running') lastProgress++;
  lastJobState = st.job.state;
  const epoch = st.latest_epoch;
  if (epoch !== null && epoch !== undefined && epoch !== lastEpoch) {{
    lastEpoch = epoch; lastProgress++;
    setImg('img-generated', `/api/render/generated/${{epoch}}.png`);
    setImg('img-reconstructed', `/api/render/reconstructed/${{epoch}}.png`);
    setImg('img-mse', `/api/render/loss_mse/${{epoch}}.svg`);
    setImg('img-total', `/api/render/loss_total/${{epoch}}.svg`);
    refreshModels();
  }}
  if (lastProgress !== lastDrawn) {{   // redraw only when progress moved —
    lastDrawn = lastProgress;          // an idle page must not re-request
    refreshDiagram(lastProgress);      // the topology SVGs every 500 ms
  }}
}}
function cfg() {{
  return {{ name: $('name').value, qpu: $('qpu').value,
           latents: +$('latents').value, epochs: +$('epochs').value }};
}}
async function startTrain() {{
  if (!validateName()) return;
  lastEpoch = -1;
  await fetchJSON('/api/train', {{method: 'POST', body: JSON.stringify(cfg())}});
}}
async function startGenerate() {{
  lastEpoch = -1;
  await fetchJSON('/api/generate', {{method: 'POST', body: JSON.stringify(
    {{model: $('model').value, sharpen: $('sharpen').checked}})}});
}}
async function startTune() {{
  lastEpoch = -1;
  await fetchJSON('/api/tune', {{method: 'POST', body: JSON.stringify(
    {{model: $('model').value, epochs: +$('tune-epochs').value}})}});
}}
async function cancelJob() {{ await fetchJSON('/api/cancel', {{method: 'POST'}}); }}
refreshModels();
setInterval(poll, 500);   // the reference's 500 ms epoch-checker interval
</script>
</body></html>
"""


def _render_page() -> str:
    qpu_options = "".join(
        f'<option value="{q}"{" selected" if q == ui_config.DEFAULT_QPU else ""}>{q}</option>'
        for q in QPU_TOPOLOGIES
    )
    s_lat, s_ep = ui_config.SLIDER_LATENTS, ui_config.SLIDER_EPOCHS
    return _PAGE.format(
        title=ui_config.APP_TITLE,
        header=ui_config.MAIN_HEADER,
        description=ui_config.DESCRIPTION,
        css=_theme_css(),
        qpu_options=qpu_options,
        lat_min=s_lat["min"], lat_max=s_lat["max"], lat_step=s_lat["step"],
        lat_val=s_lat["value"],
        ep_min=s_ep["min"], ep_max=s_ep["max"], ep_val=s_ep["value"],
    )


def _render_plain_page(jobs: "JobManager", files, workdir: Path) -> str:
    """The zero-JS fallback view: job status, progress, the latest epoch's
    figures and the problem-details table — every element produced by the
    same tested Python renderers the main page uses, refreshed by a plain
    ``<meta http-equiv=refresh>``.  This makes the full train→figures loop
    drivable end to end by pytest with no script execution anywhere
    (the main page's ~120 JS lines are pure display sugar on top of this)."""
    import html as _h

    from image_generation_tpu_torch.app.render import model_data_html, problem_details_html

    st = jobs.status()
    progress = files.read_progress()
    latest = files.latest_epoch()

    out = [
        "<!doctype html><html><head><meta charset=\"utf-8\">",
        '<link rel="icon" href="/favicon.ico">',
        '<meta http-equiv="refresh" content="2">',
        f"<title>{_h.escape(ui_config.APP_TITLE)} — status</title>",
        f"<style>{_theme_css()}</style></head><body>",
        f"<header><h1>{_h.escape(ui_config.MAIN_HEADER)} — status view"
        "</h1></header><div class=\"wrap\"><div class=\"panel results\">",
        f"<div class=\"status\">job: {_h.escape(st['state'])}"
        + (f" ({_h.escape(str(st.get('kind')))})" if st.get("kind") else "")
        + "</div>",
    ]
    if progress:
        total = progress.get("total", 1) or 1
        out.append(
            f"<progress value=\"{progress.get('step', 0)}\" max=\"{total}\">"
            f"</progress><div class=\"progress-caption\">Epochs Completed: "
            f"{progress.get('step', 0)}/{total}</div>"
        )
        if progress.get("batch") is not None:
            out.append(
                f"<div class=\"progress-caption\">Batch: {progress['batch']}"
                f"/{progress.get('n_batches')}</div>"
            )
    pd = files.dir / "problem_details.json"
    try:
        # OSError too: a job's files.clean() can rmtree generated_json
        # between exists() and read_text(), and the 2 s auto-refresh makes
        # that race routine at job start
        out.append(problem_details_html(json.loads(pd.read_text())))
    except (OSError, json.JSONDecodeError):
        pass
    if latest is not None:
        out.append(f"<h3>Epoch {latest}</h3>")
        out.append(
            f'<img class="fig" style="max-width:420px" alt="generated images" '
            f'src="/api/render/generated/{latest}.png">'
            f'<img class="fig" style="max-width:420px" alt="reconstructions" '
            f'src="/api/render/reconstructed/{latest}.png">'
            f'<br><img class="plot" style="max-width:420px" alt="MSE loss" '
            f'src="/api/render/loss_mse/{latest}.svg">'
            f'<img class="plot" style="max-width:420px" alt="total loss" '
            f'src="/api/render/loss_total/{latest}.svg">'
        )
    for meta in list_models(workdir):
        out.append(f"<h4>{_h.escape(meta['name'])}</h4>")
        out.append(model_data_html(meta))
    out.append('<div class="status"><a href="/">interactive view</a></div>')
    out.append("</div></div></body></html>")
    return "".join(out)


def _favicon() -> bytes:
    """The app icon (a copy of the JAX app's ``static/favicon.ico``)."""
    p = Path(__file__).parent / "static" / "favicon.ico"
    try:
        return p.read_bytes()
    except OSError:
        return b""


def make_server(
    workdir=".", port: int = 8050, extra_cli: list | None = None,
    host: str = "127.0.0.1", warm_generate: bool = False,
    warm_overrides: dict | None = None,
):
    """``warm_generate``: serve /api/generate and /api/generate_now from an
    in-process WarmGenerator (app/warm.py) instead of a CLI subprocess — the
    loaded model stays resident between requests — on the device the
    ``extra_cli`` flags name (``--platform cpu``, else the card; without a
    card this raises).  ``warm_overrides``: TrainingConfig overrides for
    the serving trainer (tests)."""
    workdir = Path(workdir).resolve()
    jobs = JobManager(workdir)
    files = RunFiles(workdir)
    page = _render_page().encode()
    extra = list(extra_cli or [])
    warm = None
    if warm_generate:
        from image_generation_tpu_torch.app.cli import (
            _config_overrides, _device, _spec_shape, parse_serving_args,
        )
        from image_generation_tpu_torch.app.warm import make_warm_generator
        from image_generation_tpu_torch.parallel.mesh import local_world_size

        # the warm trainer honours the same extra_cli flags every
        # subprocess job receives (e.g. --sampler-matmul-dtype int8), so
        # /api/generate serves the sampler config of this server's jobs
        sargs = parse_serving_args(extra)
        overrides = _config_overrides(sargs)
        overrides.update(warm_overrides or {})
        _spec_shape(sargs.mesh)  # a bad value exits with the CLI's message
        try:  # more ranks than cards exits with both counts
            local_world_size(sargs.mesh, _device(sargs))
        except RuntimeError as e:
            raise SystemExit(str(e))
        warm = make_warm_generator(
            workdir, device=_device(sargs), mesh=sargs.mesh, config_overrides=overrides,
            params=sargs.params, serve_max_batch=sargs.serve_max_batch,
            serve_window_ms=sargs.serve_window_ms,
        )

    def model_dir(name) -> Path | None:
        """workdir/models/<name> for a validated name, else None."""
        if not valid_name(name):
            return None
        return workdir / "models" / name

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj, code=200):
            # compact separators: figure payloads are ~1 MB of z values and
            # this handler runs per request on the serving path
            body = json.dumps(obj, separators=(",", ":")).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _bytes(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # ---------------- GET ----------------
        def _render_endpoint(self, parts):
            """/api/render/... → server-rendered PNG/SVG (app/render.py)."""
            from image_generation_tpu_torch.app import render

            tail = parts[2:]
            if len(tail) == 1 and tail[0] == "latent_strip.svg":
                vf = workdir / "assets" / "model_diagram" / "latent_encoded.json"
                if not vf.exists():
                    return self._json({"error": "no latent vector yet"}, 404)
                try:
                    values = json.loads(vf.read_text())
                except json.JSONDecodeError:
                    return self._json({"error": "latent vector being written"}, 404)
                return self._bytes(
                    render.latent_strip_svg(values).encode(), "image/svg+xml"
                )
            if len(tail) == 2 and tail[0] in ("generated", "reconstructed"):
                fig = files.read_epoch_figure(tail[0], _safe_epoch(tail[1], ".png"))
                if fig is None:
                    return self._json({"error": "not found"}, 404)
                return self._bytes(render.render_heatmap_png(fig), "image/png")
            if len(tail) == 2 and tail[0] in ("loss_mse", "loss_total"):
                fig = files.read_epoch_figure(tail[0], _safe_epoch(tail[1], ".svg"))
                if fig is None:
                    return self._json({"error": "not found"}, 404)
                color = (
                    ui_config.THEME_COLOR_SECONDARY
                    if tail[0] == "loss_mse"
                    else ui_config.THEME_COLOR
                )
                return self._bytes(
                    render.render_loss_svg(fig, color).encode(), "image/svg+xml"
                )
            if len(tail) == 3 and tail[0] == "topology":
                name, kind = tail[1], tail[2]
                if kind.endswith(".svg"):
                    kind = kind[: -len(".svg")]
                model = model_dir(name)
                if model is None or not (model / "grbm.pth").exists():
                    return self._json({"error": "unknown model"}, 404)
                fig = _topology_fig(model, kind)
                return self._bytes(
                    render.render_topology_svg(fig).encode(), "image/svg+xml"
                )
            return self._json({"error": "not found"}, 404)

        def do_GET(self):
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            if url.path == "/":
                return self._bytes(page, "text/html; charset=utf-8")
            if url.path == "/plain":
                return self._bytes(
                    _render_plain_page(jobs, files, workdir).encode(),
                    "text/html; charset=utf-8",
                )
            if url.path == "/favicon.ico":
                ico = _favicon()
                if not ico:
                    return self._json({"error": "not found"}, 404)
                return self._bytes(ico, "image/x-icon")
            if url.path == "/api/state":
                return self._json({
                    "job": jobs.status(),
                    "progress": files.read_progress(),
                    "latest_epoch": files.latest_epoch(),
                })
            if url.path == "/api/models":
                return self._json(list_models(workdir))
            if len(parts) == 3 and parts[:2] == ["api", "model_data_html"]:
                # the selected-model data card (reference generate_model_data,
                # demo_interface.py:179-202), server-rendered like every
                # other pixel on the page
                from image_generation_tpu_torch.app.render import model_data_html

                model = model_dir(parts[2])
                pj = model / "parameters.json" if model is not None else None
                if pj is None or not pj.exists():
                    return self._json({"error": "unknown model"}, 404)
                try:
                    # OSError too: the model dir can be rmtree'd between
                    # exists() and read_text() (same race as /plain)
                    meta = json.loads(pj.read_text())
                except (OSError, json.JSONDecodeError):
                    return self._json({"html": ""})
                return self._json({"html": model_data_html(meta)})
            if len(parts) >= 3 and parts[:2] == ["api", "render"]:
                try:
                    return self._render_endpoint(parts)
                except (ValueError, KeyError, TypeError, OSError):
                    return self._json({"error": "bad figure"}, 404)
            if len(parts) == 4 and parts[:2] == ["api", "figure"]:
                try:
                    epoch = int(parts[3])
                except ValueError:
                    return self._json({"error": "bad epoch"}, 404)
                fig = files.read_epoch_figure(parts[2], epoch)
                return self._json(fig if fig is not None else {}, 200 if fig else 404)
            if url.path == "/api/problem_details":
                p = files.dir / "problem_details.json"
                try:  # files.clean() can rmtree between exists() and read
                    return self._json(json.loads(p.read_text()))
                except (OSError, json.JSONDecodeError):
                    return self._json({})
            if url.path == "/api/problem_details_html":
                from image_generation_tpu_torch.app.render import problem_details_html

                p = files.dir / "problem_details.json"
                try:  # OSError: same clean()-race as /api/problem_details
                    details = json.loads(p.read_text())
                except (OSError, json.JSONDecodeError):
                    return self._json({"html": ""})
                return self._json({"html": problem_details_html(details)})
            if len(parts) == 4 and parts[:2] == ["api", "topology"]:
                # /api/topology/<model>/<encoded|qpu>  (figure JSON, parity)
                model = model_dir(parts[2])
                if model is None or not (model / "grbm.pth").exists():
                    return self._json({"error": "unknown model"}, 404)
                return self._json(_topology_fig(model, parts[3]))
            if parts and parts[0] == "assets":
                f = workdir.joinpath(*parts)
                if f.is_file() and f.resolve().is_relative_to(workdir):
                    ctype = "image/png" if f.suffix == ".png" else "application/json"
                    return self._bytes(f.read_bytes(), ctype)
                # pre-model placeholder shipped with the package (reference:
                # assets/model_diagram/step_5_output_default.png, shown in
                # the diagram's output slot until a model renders —
                # demo_interface.py:608)
                if parts[1:] == ["model_diagram", "step_5_output_default.png"]:
                    p = Path(__file__).parent / "static" / parts[-1]
                    if p.is_file():
                        return self._bytes(p.read_bytes(), "image/png")
            self._json({"error": "not found"}, 404)

        # ---------------- POST ----------------
        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                return self._json({"error": "bad json"}, 400)
            if self.path == "/api/train":
                name = body.get("name", "tpu_model")
                if not valid_name(name):
                    return self._json({"error": "invalid model name"}, 400)
                ok = jobs.start("train", [
                    "train", "--name", name,
                    "--qpu", str(body.get("qpu", ui_config.DEFAULT_QPU)),
                    "--latents", str(int(body.get("latents", 256))),
                    "--epochs", str(int(body.get("epochs", 10))),
                ] + extra)
                return self._json({"started": ok}, 200 if ok else 409)
            if self.path == "/api/generate_now":
                # synchronous, coalescing warm serving: concurrent requests
                # share one fused sample→decode dispatch (app/warm.py
                # serve()); returns the figure directly — no workdir
                # artifacts, no job slot, so it serves any number of
                # concurrent clients beside the job-based UI flow
                if warm is None:
                    return self._json(
                        {"error": "warm serving disabled (--warm-generate)"},
                        400,
                    )
                model = model_dir(body.get("model", ""))
                if model is None:
                    return self._json({"error": "invalid model name"}, 400)
                if not (model / "dvae.pth").exists():
                    return self._json({"error": "unknown model"}, 404)
                from image_generation_tpu_torch.app.figures import imshow_figure

                t0 = time.perf_counter()
                try:
                    out = warm.serve(model, sharpen=bool(body.get("sharpen")))
                except Exception:
                    # full trace server-side only: exception text can leak
                    # filesystem paths/internal state to clients when the
                    # server is exposed via --host
                    traceback.print_exc()
                    return self._json(
                        {"error": "generation failed (see server log)"}, 500
                    )
                # snapshot BEFORE the figure encode: latency_ms is the serve
                # (queue + fused dispatch) latency, not the host JSON build
                lat_ms = (time.perf_counter() - t0) * 1e3
                return self._json({
                    "figure": imshow_figure(out["grid"]),
                    "batched": out["batched"],
                    "latency_ms": round(lat_ms, 2),
                })
            if self.path in ("/api/generate", "/api/tune", "/api/refresh_model"):
                model = model_dir(body.get("model", ""))
                if model is None:
                    return self._json({"error": "invalid model name"}, 400)
                if not (model / "dvae.pth").exists():
                    return self._json({"error": "unknown model"}, 404)
                if self.path == "/api/generate":
                    if warm is not None:
                        sharpen = bool(body.get("sharpen"))
                        ok = jobs.start_call(
                            "generate", lambda: warm.generate(model, sharpen)
                        )
                        return self._json({"started": ok}, 200 if ok else 409)
                    args = ["generate", "--model", str(model)]
                    if body.get("sharpen"):
                        args.append("--sharpen")
                    ok = jobs.start("generate", args + extra)
                elif self.path == "/api/tune":
                    ok = jobs.start("tune", [
                        "tune", "--model", str(model),
                        "--epochs", str(int(body.get("epochs", 5))),
                    ] + extra)
                else:
                    ok = jobs.start(
                        "refresh", ["refresh", "--model", str(model)] + extra
                    )
                return self._json({"started": ok}, 200 if ok else 409)
            if self.path == "/api/cancel":
                return self._json({"cancelled": jobs.cancel()})
            self._json({"error": "not found"}, 404)

    def _safe_epoch(seg: str, suffix: str) -> int:
        if seg.endswith(suffix):
            seg = seg[: -len(suffix)]
        return int(seg)  # ValueError → caught by the render guard → 404

    _topo_cache: dict = {}
    _topo_lock = threading.Lock()

    def _topology_fig(model: Path, kind: str) -> dict:
        values = None
        vf = workdir / "assets" / "model_diagram" / f"latent_{kind}.json"
        if vf.exists():
            try:
                values = json.loads(vf.read_text())
            except json.JSONDecodeError:
                values = None
        from image_generation_tpu_torch.app.figures import model_topology_figure

        # building the figure re-reads grbm.pth and computes a graph layout
        # (spring_layout for checkpoints without physical coordinates) —
        # memoize on the checkpoint's mtime and the latent values so polling
        # clients don't recompute identical figures
        try:
            mtime = (model / "grbm.pth").stat().st_mtime_ns
        except OSError:
            mtime = None
        ck = (str(model), kind, mtime, None if values is None else tuple(values))
        # handler threads share the cache: hold the computed figure in a
        # local and return THAT (another thread's clear() between insert and
        # a dict re-read would raise KeyError and 500 a poll request)
        with _topo_lock:
            fig = _topo_cache.get(ck)
        if fig is None:
            fig = model_topology_figure(model, values)
            with _topo_lock:
                if len(_topo_cache) > 8:  # bound: a handful of (model, kind) pairs
                    _topo_cache.clear()
                _topo_cache[ck] = fig
        return fig

    class _Server(ThreadingHTTPServer):
        # socketserver's default listen backlog is 5: a burst of concurrent
        # /api/generate_now clients (the coalescer exists for exactly that)
        # overflows it and later connects get RST.  64 covers any burst the
        # coalescer's max_batch can drain in a couple of dispatches.
        request_queue_size = 64

        def shutdown(self):
            """Stop serving, then the warm followers, if any."""
            super().shutdown()
            if warm is not None:
                warm.close()

    server = _Server((host, port), Handler)
    server.jobs = jobs  # for tests/embedding
    server.warm = warm
    return server


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8050)
    ap.add_argument("--workdir", default=".")
    ap.add_argument(
        "--host", default="127.0.0.1",
        help="bind address (default loopback; 0.0.0.0 to expose)",
    )
    ap.add_argument("--debug", action="store_true")  # reference --debug flag
    ap.add_argument(
        "--warm-generate", action="store_true",
        help="serve /api/generate and /api/generate_now from an in-process warm "
        "trainer (the model stays resident on the device between requests) instead "
        "of a per-request CLI subprocess",
    )
    # unknown flags pass through to every job subprocess AND the warm
    # serving trainer (parse_serving_args): e.g.
    #   python -m image_generation_tpu_torch.app.server --warm-generate \
    #       --platform cpu --serve-max-batch 32
    args, extra = ap.parse_known_args(argv)
    from image_generation_tpu_torch.app.cli import validate_extra_cli

    validate_extra_cli(extra)  # a mistyped server flag must die at startup
    server = make_server(
        args.workdir, args.port, extra_cli=extra, host=args.host,
        warm_generate=args.warm_generate,
    )
    print(f"serving on http://{args.host}:{args.port} (workdir={args.workdir})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
