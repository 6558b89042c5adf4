"""File-IPC protocol between the training job and the UI/driver process.

Port of ``image_generation_tpu/app/files.py``, the same protocol: the
trainer writes per-epoch plotly-figure JSONs and a problem-details JSON
into ``generated_json/``, which the UI polls; saved models live under
``models/``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional

from image_generation_tpu_torch.app.figures import imshow_figure, loss_figure, write_figure

__all__ = ["RunFiles", "UnwrittenRunFiles", "JSON_FILE_DIR", "list_models"]

JSON_FILE_DIR = "generated_json"
MODELS_DIR = "models"


class RunFiles:
    """Writer side of the epoch-file protocol (one instance per run)."""

    def __init__(self, root: str | Path = ".", json_dir: str = JSON_FILE_DIR):
        self.root = Path(root)
        self.dir = self.root / json_dir
        self.diagram_dir = self.root / "assets" / "model_diagram"
        self.dir.mkdir(parents=True, exist_ok=True)

    # -- lifecycle ----------------------------------------------------
    def clean(self) -> None:
        """Remove stale epoch files at run start (demo_callbacks.py:516-527)."""
        if self.dir.exists():
            shutil.rmtree(self.dir)
        self.dir.mkdir(parents=True, exist_ok=True)

    def metrics_log(self):
        """The run's ``observability.MetricsLog`` (``metrics.jsonl``)."""
        from image_generation_tpu_torch.training.observability import MetricsLog

        return MetricsLog(self.dir / "metrics.jsonl")

    # -- per-epoch artifacts (callback_helpers.py:192-219) -------------
    def write_epoch(
        self,
        epoch: int,
        generated_grid,
        reconstructed_grid,
        mse_losses,
        total_losses,
    ) -> None:
        write_figure(imshow_figure(generated_grid), self.dir / f"generated_epoch_{epoch}.json")
        write_figure(
            imshow_figure(reconstructed_grid), self.dir / f"reconstructed_epoch_{epoch}.json"
        )
        write_figure(loss_figure(mse_losses), self.dir / f"loss_mse_epoch_{epoch}.json")
        write_figure(loss_figure(total_losses), self.dir / f"loss_total_epoch_{epoch}.json")

    def write_problem_details(
        self,
        qpu: str,
        n_latents: int,
        n_edges: int,
        num_reads: int,
        sampler: str,
        extra: Optional[dict] = None,
    ) -> None:
        """The UI's problem-details table source.  Keys are display-ready
        headers, exactly like the reference's per-epoch dump
        (src/utils/callback_helpers.py:193-204) rendered by
        ``generate_problem_details_table`` (demo_interface.py:383-399).
        ``extra`` appends/overrides columns — the per-epoch writer passes
        Epoch / Batch Size / both learning rates / the MSE loss there."""
        details = {
            "QPU": qpu,
            "Latents": n_latents,
            "Couplers": n_edges,
            "Reads": num_reads,
            "Sampler": sampler,
        }
        if extra:
            details.update(extra)
        (self.dir / "problem_details.json").write_text(json.dumps(details))

    def write_progress(
        self,
        step: int,
        total: int,
        batch: Optional[int] = None,
        n_batches: Optional[int] = None,
    ) -> None:
        """Progress for the UI bar — the diskcache set_progress equivalent
        (callback_helpers.py:178).  ``step``/``total`` count epochs;
        ``batch``/``n_batches`` add the within-epoch counts the reference's
        progress captions show (demo_callbacks.py:358-385: "Epochs
        Completed: x/N" and "Batch: y/M")."""
        payload = {"step": step, "total": total}
        if batch is not None and n_batches is not None:
            payload["batch"] = batch
            payload["n_batches"] = n_batches
        (self.dir / "progress.json").write_text(json.dumps(payload))

    # -- model-diagram latent vectors (demo_callbacks.py:149-159) ------
    def write_latent_encoded(self, spins) -> None:
        self.diagram_dir.mkdir(parents=True, exist_ok=True)
        with open(self.diagram_dir / "latent_encoded.json", "w") as f:
            json.dump([float(v) for v in spins], f)

    def write_latent_qpu(self, spins) -> None:
        self.diagram_dir.mkdir(parents=True, exist_ok=True)
        with open(self.diagram_dir / "latent_qpu.json", "w") as f:
            json.dump([float(v) for v in spins], f)

    # -- reader side (what the UI process does) ------------------------
    def read_epoch_figure(self, kind: str, epoch: int) -> Optional[dict]:
        p = self.dir / f"{kind}_epoch_{epoch}.json"
        if not p.exists():
            return None
        try:
            return json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            return None  # partially-written file: "epoch not done yet"

    def read_progress(self) -> Optional[dict]:
        p = self.dir / "progress.json"
        if not p.exists():
            return None
        try:
            return json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            return None

    def latest_epoch(self) -> Optional[int]:
        """Highest epoch with a generated-images figure on disk (what the
        page poll and the /plain view both key their redraw on)."""
        latest = None
        for p in self.dir.glob("generated_epoch_*.json"):
            try:
                latest = max(latest or -1, int(p.stem.rsplit("_", 1)[1]))
            except ValueError:
                pass
        return latest


class UnwrittenRunFiles(RunFiles):
    """``RunFiles`` of a process that writes nothing (a mesh rank other
    than 0): the same paths, every writer a no-op, no metrics log and no
    diagram directory, so the CLI runs one command body on every rank."""

    def __init__(self, root: str | Path = ".", json_dir: str = JSON_FILE_DIR):
        self.root = Path(root)
        self.dir = self.root / json_dir
        self.diagram_dir = None

    def metrics_log(self):
        return None

    def clean(self) -> None:
        pass

    def write_epoch(self, *args, **kwargs) -> None:
        pass

    def write_problem_details(self, *args, **kwargs) -> None:
        pass

    def write_progress(self, *args, **kwargs) -> None:
        pass

    def write_latent_encoded(self, spins) -> None:
        pass

    def write_latent_qpu(self, spins) -> None:
        pass


def list_models(workdir: str | Path) -> list[dict]:
    """Saved model dirs under ``workdir/models`` with their parameters.json
    metadata (name-sorted; unreadable/partial dirs skipped) — the backing
    of /api/models and the /plain model cards."""
    out = []
    root = Path(workdir) / MODELS_DIR
    if root.exists():
        for d in sorted(root.iterdir()):
            pj = d / "parameters.json"
            if pj.exists():
                try:
                    meta = json.loads(pj.read_text())
                except (json.JSONDecodeError, OSError):
                    continue
                out.append({"name": d.name, **meta})
    return out
