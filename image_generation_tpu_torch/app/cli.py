"""Command-line application surface: train / generate / tune / refresh / tune-pt / models.

Port of ``image_generation_tpu/app/cli.py``: the same subcommands, option
strings and artifacts (model directories under ``models/``, per-epoch
figure JSONs and ``problem_details.json`` under ``generated_json/``, the
model-diagram images under ``assets/model_diagram/``), so a model trained
by either package's CLI is generated from by the other's.

Usage:
  python -m image_generation_tpu_torch.app.cli train --name my_model --epochs 10
  python -m image_generation_tpu_torch.app.cli generate --model my_model
  python -m image_generation_tpu_torch.app.cli tune --model my_model --epochs 5
  python -m image_generation_tpu_torch.app.cli refresh --model my_model
  python -m image_generation_tpu_torch.app.cli tune-pt --model my_model
  python -m image_generation_tpu_torch.app.cli models      # list saved models

Every command runs on the CUDA card unless given ``--platform cpu``; with
no card visible the default raises.  Sampling runs the sweep kernels
(``csrc/gibbs_sparse.cu`` on the card): training through the step's
dispatch, ``generate`` through the ``samplers/`` backends, ``tune-pt``
through the dispatch's sweeps with the energy carry.  ``tune-pt``
feedback-optimizes the parallel-tempering ladder for a model's GRBM
(``ops/pt_tune.py``) and writes ``<model>/pt_betas.json``; every command
accepts ``--pt-betas <json|comma list>`` (implies ``--sampler pt``).

``--mesh``: 'auto' (the default) uses the initialised ``torch.distributed``
world (one device when there is none), 'off' one device, a count ('4')
the JAX default shape over an initialised world of that many ranks, and
RxG ('2x2', '1x4') the explicit (data × graph) layout; every rank of the
world runs the same command.  Any config trains on any of them, the
scaled one too (its outsized dense layer is column-sharded over the
mesh, ``parallel/dense.py``).  ``--params`` reads a YAML file and needs
PyYAML.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _config_overrides(args):
    """Map parsed CLI args to TrainingConfig field overrides."""
    overrides = {}
    if args.latents is not None:
        overrides["N_LATENTS"] = args.latents
    if args.dataset_size is not None:
        overrides["DATASET_SIZE"] = args.dataset_size
    if args.batch_size is not None:
        overrides["BATCH_SIZE"] = args.batch_size
    for flag, field in (("sweeps", "GIBBS_SWEEPS"), ("graph_sharded", "GRAPH_SHARDED"),
                        ("adam_moment_dtype", "ADAM_MOMENT_DTYPE"),
                        ("adam_factored_nu", "ADAM_FACTORED_NU"),
                        ("sampler_matmul_dtype", "SAMPLER_MATMUL_DTYPE"),
                        ("sweep_block_sparse", "SWEEP_BLOCK_SPARSE"),
                        ("plrng_row_seed", "PLRNG_ROW_SEED"),
                        ("sweep_bs_chunk", "SWEEP_BS_CHUNK"), ("sampler", "SAMPLER")):
        if getattr(args, flag, None) is not None:
            overrides[field] = getattr(args, flag)
    if getattr(args, "pt_num_betas", None) is not None:
        v = args.pt_num_betas
        overrides["PT_NUM_BETAS"] = v if v == "auto" else int(v)
        overrides.setdefault("SAMPLER", "pt")  # a rung count implies PT
    if getattr(args, "pt_betas", None):
        overrides["PT_BETAS"] = _parse_pt_betas(args.pt_betas)
        overrides.setdefault("SAMPLER", "pt")  # a ladder implies PT
    if getattr(args, "pt_adapt", None) is not None:
        overrides["PT_ADAPT"] = args.pt_adapt
        if args.pt_adapt == "epoch":  # only enabling adaptation implies PT
            overrides.setdefault("SAMPLER", "pt")
    return overrides


def _device(args) -> str:
    """``--platform`` → the torch device: the card by default, "cpu" on
    request."""
    platform = (getattr(args, "platform", None) or "cuda").lower()
    if platform == "cpu":
        return "cpu"
    if platform in ("cuda", "gpu"):
        return "cuda"
    raise SystemExit(f"--platform must be 'cpu' or 'cuda' (the default), got {platform!r}")


def _build_trainer(args, for_load: bool = False, serving_model_dir=None):
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.training.trainer import Trainer

    overrides = _config_overrides(args)
    cfg = (TrainingConfig.from_yaml(args.params, **overrides) if args.params
           else TrainingConfig(**overrides))
    if not for_load:
        cfg = cfg.replace(QPU=args.qpu)
    if serving_model_dir is not None:
        # the generation surface: at-scale checkpoints default to the int8
        # sampler, as warm serving resolves them
        cfg = cfg.for_serving_dir(serving_model_dir)
    return Trainer(config=cfg, device=_device(args),
                   mesh=parse_mesh(getattr(args, "mesh", "auto")))


def _parse_pt_betas(spec):
    """``--pt-betas`` value → ladder list: a comma-separated ladder
    ('0.25,0.5,1.0') or the path of a ``pt_betas.json`` written by
    ``tune-pt``."""
    p = Path(spec)
    if p.suffix == ".json" and p.exists():
        try:
            return [float(x) for x in json.loads(p.read_text())["betas"]]
        except (OSError, json.JSONDecodeError, KeyError, TypeError, ValueError):
            raise SystemExit(
                f"--pt-betas file {spec!r} is not a tune-pt output "
                f'(expected JSON with a numeric "betas" list)'
            )
    try:
        return [float(x) for x in str(spec).split(",")]
    except ValueError:
        raise SystemExit(
            f"--pt-betas must be a comma-separated ascending ladder ending "
            f"at 1.0, or a pt_betas.json path; got {spec!r}"
        )


def parse_mesh(spec):
    """``--mesh`` value → Mesh | None | "auto" (the Trainer's sentinel).

    'off' → None (one device); 'auto' → the initialised world, if any; a
    count ('8') → the JAX default-shaped mesh over an initialised world of
    that many ranks; RxG ('2x4') → the explicit (data × graph) layout
    (``parallel.mesh.create_mesh``; the graph axis carries the chains, or
    under ``GRAPH_SHARDED`` the coupling)."""
    if spec == "off":
        return None
    if spec in (None, "auto"):
        return spec
    import torch.distributed as dist

    from image_generation_tpu_torch.parallel.mesh import create_mesh, default_shape

    try:
        s = str(spec).lower()
        if "x" in s:
            rows, cols = (int(x) for x in s.split("x"))
            if rows < 1 or cols < 1:
                raise ValueError("axis sizes must be >= 1")
            shape = (rows, cols)
        else:
            n = int(s)
            if n < 1:
                raise ValueError("device count must be >= 1")
            shape = default_shape(n)
    except ValueError as e:
        raise SystemExit(
            f"--mesh must be 'auto', 'off', a device count, or RxG (e.g. 1x8); got {spec!r} ({e})"
        )
    backend = dist.get_backend() if dist.is_available() and dist.is_initialized() else "nccl"
    try:
        return create_mesh(shape=shape, backend=backend)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"--mesh {spec}: {e}")


def _write_details(trainer, files, epoch=None, n_epochs=None, mse=None, stats=None):
    """problem_details.json with the reference's display headers (QPU /
    Epoch / Batch Size / Latents / both learning rates / the current MSE)
    plus the sampler columns (and the live PT ladder's health under PT)."""
    extra = {"Batch Size": trainer.config.BATCH_SIZE}
    if epoch is not None and n_epochs is not None:
        extra["Epoch"] = f"{epoch + 1}/{n_epochs}"
    if trainer.state is not None and trainer.fns is not None:
        lr_d, lr_g = trainer.current_lrs()
        extra["Learning rate DVAE"] = f"{lr_d:.3E}"
        extra["Learning rate GRBM"] = f"{lr_g:.3E}"
    if mse is not None:
        extra["Mean Squared Error Loss"] = f"{mse:.4f}"
    if stats and "pt_accept_min" in stats:
        extra["PT swap acceptance (min/mean)"] = (
            f"{stats['pt_accept_min']:.3f} / {stats['pt_accept_mean']:.3f}"
        )
        if "pt_betas" in stats:
            b = stats["pt_betas"]
            extra["PT ladder (adapted)"] = f"[{b[0]:.3g} … {b[-1]:.3g}] × {len(b)}"
        if "pt_recommended_num_betas" in stats:
            extra["PT rungs (used/recommended)"] = (
                f"{trainer.config.PT_NUM_BETAS} / {stats['pt_recommended_num_betas']}"
            )
    files.write_problem_details(
        qpu=trainer.qpu,
        n_latents=trainer.n_latents,
        n_edges=trainer.graph.n_edges if trainer.graph else 0,
        num_reads=trainer.config.NUM_READS,
        sampler=trainer.config.SAMPLER,
        extra=extra,
    )


def _attach_files(trainer, args):
    from image_generation_tpu_torch.app.files import RunFiles

    files = RunFiles(args.workdir)
    files.clean()
    _write_details(trainer, files)
    return files


def _write_diagram_assets(trainer, files, gen):
    """Latent vector + model-diagram assets.  Callers write these before
    the poll triggers (epoch figure JSONs / progress): the web page redraws
    the images once per progress move."""
    from image_generation_tpu_torch.app import ui_config
    from image_generation_tpu_torch.app.diagram import generate_model_diagram

    files.write_latent_qpu(gen["latents"][0])
    if ui_config.GENERATE_NEW_MODEL_DIAGRAM:
        example = trainer.images[ui_config.EXAMPLE_IMAGE_INDEX]
        generate_model_diagram(trainer, example, files.root / "assets" / "model_diagram")


def _print_epoch(e, n_epochs, stats):
    print(f"epoch {e + 1}/{n_epochs}: mse={stats['mse']:.4f} "
          f"total={stats['dvae_loss']:.4f} ({stats['epoch_time_s']:.1f}s)", flush=True)


def _epoch_artifacts(trainer, files, epoch, stats, n_epochs):
    gen = trainer.generate_output()
    rec = trainer.generate_reconstructed_samples()
    _write_diagram_assets(trainer, files, gen)  # assets first, triggers last
    files.write_epoch(epoch, gen["grid"], rec["grid"], trainer.losses["mse_losses"],
                      trainer.losses["dvae_losses"])
    files.write_progress(epoch + 1, n_epochs, trainer.n_batches, trainer.n_batches)
    _print_epoch(epoch, n_epochs, stats)


def cmd_train(args):
    from image_generation_tpu_torch.training.observability import MetricsLog

    trainer = _build_trainer(args)
    trainer.train_init(args.epochs)
    files = _attach_files(trainer, args)
    metrics = MetricsLog(Path(args.workdir) / "generated_json" / "metrics.jsonl")
    print(
        f"training: qpu={trainer.qpu} latents={trainer.n_latents} "
        f"edges={trainer.graph.n_edges} data={trainer.data_source.origin} "
        f"batches/epoch={trainer.n_batches} sampler={trainer.fns.sampler_impl} "
        f"device={trainer.device}"
        + (f" mesh={tuple(trainer.mesh.shape)}" if trainer.mesh else ""),
        flush=True,
    )
    every = max(args.artifact_every, 1)

    def _cb(e, s):
        _write_details(trainer, files, epoch=e, n_epochs=args.epochs, mse=s["mse"], stats=s)
        if (e + 1) % every == 0 or e + 1 == args.epochs:
            _epoch_artifacts(trainer, files, e, s, args.epochs)
        else:
            files.write_progress(e + 1, args.epochs, trainer.n_batches, trainer.n_batches)
            _print_epoch(e, args.epochs, s)

    trainer.train(
        args.epochs,
        epoch_cb=_cb,
        metrics_log=metrics,
        profile_dir=args.profile,
        batch_cb=lambda e, done, nb: files.write_progress(e, args.epochs, done, nb),
        epoch_chunks=args.progress_chunks,
    )
    out = Path(args.workdir) / "models" / args.name
    trainer.save(out, n_epochs=args.epochs)
    print(f"saved: {out}")


def _model_path(args) -> Path:
    """``--model``: a path as given, or a bare model name looked up under
    ``workdir/models/``."""
    p = Path(args.model)
    if not p.exists():
        candidate = Path(args.workdir) / "models" / args.model
        if candidate.exists():
            return candidate
    return p


def cmd_generate(args):
    model_dir = _model_path(args)
    trainer = _build_trainer(args, for_load=True, serving_model_dir=model_dir)
    trainer.load(model_dir)
    gen = trainer.generate_output(do_sharpen=args.sharpen, num_reads=args.num_reads)
    files = _attach_files(trainer, args)
    rec = trainer.generate_reconstructed_samples(do_sharpen=args.sharpen)
    _write_diagram_assets(trainer, files, gen)  # assets before the epoch-figure trigger
    files.write_epoch(0, gen["grid"], rec["grid"],
                      trainer.losses["mse_losses"], trainer.losses["dvae_losses"])
    print(f"generated {gen['images'].shape[0]} images → "
          f"{files.dir / 'generated_epoch_0.json'}")


def cmd_refresh(args):
    """Regenerate the model-diagram assets for a saved checkpoint without a
    training or generation job (the reference's on-model-switch refresh)."""
    from image_generation_tpu_torch.app import ui_config
    from image_generation_tpu_torch.app.diagram import generate_model_diagram
    from image_generation_tpu_torch.app.files import RunFiles

    trainer = _build_trainer(args, for_load=True)
    trainer.load(_model_path(args))
    files = RunFiles(args.workdir)  # no clean(): keep prior epoch figures
    example = trainer.images[ui_config.EXAMPLE_IMAGE_INDEX]
    out = generate_model_diagram(trainer, example, Path(args.workdir) / "assets" / "model_diagram")
    _write_details(trainer, files)
    print(f"refreshed model diagram for {args.model}: {sorted(out)}")


def cmd_tune(args):
    trainer = _build_trainer(args, for_load=True)
    model_dir = _model_path(args)
    trainer.load(model_dir)
    # a copy: train_init() clears these very lists in place
    old_losses = {k: list(v) for k, v in trainer.losses.items()}
    old_params = json.loads((model_dir / "parameters.json").read_text())
    trainer.train_init(args.epochs)
    files = _attach_files(trainer, args)
    trainer.train(
        args.epochs,
        epoch_cb=lambda e, s: _epoch_artifacts(trainer, files, e, s, args.epochs),
        batch_cb=lambda e, done, nb: files.write_progress(e, args.epochs, done, nb),
        epoch_chunks=args.progress_chunks,
    )
    name = f"{Path(args.model).name}_tuned_{args.epochs}_epochs"
    out = Path(args.workdir) / "models" / name
    trainer.save(out, n_epochs=old_params.get("n_epochs", 0) + args.epochs,
                 old_losses=old_losses)
    print(f"saved: {out}")


def tune_ladder(trainer, seed: int = 0, n_iters: int = 3, n_chains: int = 256,
                verbose: bool = False):
    """``tune_pt_betas`` on a loaded trainer's model as training samples
    it (the train state's cached sampler model: int8, bf16 at scale,
    packed, a rank's rows under graph sharding) through the dispatch's
    sweeps and energies, from the config's initial ladder.  Returns
    ``(betas, diag_before, diag_after)``, the ladder ending at exactly 1.0."""
    import torch

    from image_generation_tpu_torch.ops.pt_tune import tune_pt_betas

    fns, st = trainer.fns, trainer.state
    g = torch.Generator(device=trainer.device)
    g.manual_seed(seed)
    tuned, diag0, diag1 = tune_pt_betas(
        g, st.sampler_h, st.sampler_coupling, trainer.plan, trainer.config.initial_pt_betas(),
        n_iters=n_iters, n_chains=n_chains, verbose=verbose, sweeps_fn=fns.sweeps_fn,
        energies_fn=fns.energies, local=fns.local,
    )
    tuned[-1] = 1.0  # the PT_BETAS contract: the ladder ends exactly at the target
    return tuned, diag0, diag1


def cmd_tune_pt(args):
    """Feedback-optimize the PT ladder for a saved model's GRBM
    (``tune_ladder``) and write ``<model>/pt_betas.json``."""
    from image_generation_tpu_torch.ops.pt_tune import recommend_num_betas

    trainer = _build_trainer(args, for_load=True)
    if trainer.config.PT_NUM_BETAS == "auto":
        # tune-pt is the offline sizing path: start from the 16-rung
        # geometric probe ladder size_ladder uses
        trainer.config = trainer.config.replace(PT_NUM_BETAS=16)
    model_dir = _model_path(args)
    trainer.load(model_dir)
    tuned, diag0, diag1 = tune_ladder(trainer, args.seed, args.iters, args.chains, verbose=True)
    out_path = model_dir / "pt_betas.json"
    out_path.write_text(json.dumps({
        "betas": [float(b) for b in tuned],
        "accept_before": [round(float(a), 4) for a in diag0.accept],
        "accept_after": [round(float(a), 4) for a in diag1.accept],
        "barrier_before": round(diag0.barrier, 4),
        "barrier_after": round(diag1.barrier, 4),
        "recommended_num_betas": recommend_num_betas(diag1.accept),
    }, indent=1))
    ladder = ",".join(f"{b:.5g}" for b in tuned)
    print(f"saved: {out_path}")
    print(f"use with: --pt-betas {out_path}  (or --pt-betas {ladder})")


def cmd_models(args):
    from image_generation_tpu_torch.app.files import list_models

    metas = list_models(args.workdir)
    if not metas:
        print("(no saved models)")
        return
    for meta in metas:
        print(f"{meta['name']}: qpu={meta.get('qpu')} "
              f"latents={meta.get('n_latents')} epochs={meta.get('n_epochs')}")


def build_parser():
    ap = argparse.ArgumentParser(prog="image_generation_tpu_torch")
    ap.add_argument("--workdir", default=".", help="artifact root (models/, generated_json/)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--qpu", default="Advantage2_system1")
    common.add_argument("--latents", type=int, default=None)
    common.add_argument("--dataset-size", type=int, default=None)
    common.add_argument("--batch-size", type=int, default=None)
    common.add_argument("--sweeps", type=int, default=None, help="Gibbs sweeps per refresh")
    common.add_argument("--params", default=None,
                        help="training parameters YAML (needs PyYAML)")
    common.add_argument("--profile", default=None, help="torch.profiler trace directory")
    common.add_argument("--platform", default=None,
                        help="'cpu' runs on the CPU; the default is the CUDA card")
    common.add_argument(
        "--mesh", default="auto",
        help="'auto' (the initialised torch.distributed world, the default), 'off' (one "
        "device), a rank count (e.g. 4: the default (data, graph) shape), or RxG "
        "(e.g. 2x2, 1x4: data x graph)",
    )
    common.add_argument(
        "--graph-sharded", default=None, choices=["auto", "on", "off"],
        help="partition the GRBM coupling rows over the mesh's graph axis",
    )
    common.add_argument(
        "--adam-moment-dtype", default=None, choices=["float32", "bfloat16"],
        help="storage dtype of the DVAE Adam moments",
    )
    common.add_argument(
        "--adam-factored-nu", default=None, choices=["on", "off"],
        help="factored second moments of large 2-D DVAE params",
    )
    common.add_argument(
        "--sampler-matmul-dtype", default=None,
        choices=["auto", "float32", "bfloat16", "int8"],
        help="the sampler coupling's stored type (default auto = bf16 on large graphs; "
        "int8 samples the int8-quantized model)",
    )
    common.add_argument(
        "--sweep-block-sparse", default=None, choices=["auto", "on", "off"],
        help="pack the sampler coupling into its occupied chunk panels (default auto = on "
        "for large sparse graphs)",
    )
    common.add_argument(
        "--plrng-row-seed", default=None, choices=["on", "off"],
        help="seed the graph-sharded update kernel's generator per global row group",
    )
    common.add_argument(
        "--sweep-bs-chunk", default=None, type=int,
        help="block-sparse chunk height in rows (default 256)",
    )
    common.add_argument(
        "--sampler", default=None, choices=["gibbs", "pt", "exact"],
        help="negative-phase sampler (default gibbs; 'pt' runs a parallel-tempering "
        "ladder, see tune-pt)",
    )
    common.add_argument(
        "--pt-num-betas", default=None,
        help="PT ladder size: an int, or 'auto' to size it from a swap-acceptance probe "
        "(implies --sampler pt; an explicit --pt-betas ladder wins)",
    )
    common.add_argument(
        "--pt-betas", default=None,
        help="explicit PT ladder: comma-separated ascending betas ending at 1.0, or a "
        "pt_betas.json written by tune-pt (implies --sampler pt)",
    )
    common.add_argument(
        "--pt-adapt", default=None, choices=["off", "epoch"],
        help="re-space the live PT ladder after every epoch from the step's swap "
        "acceptance (implies --sampler pt)",
    )
    common.add_argument(
        "--serve-max-batch", type=int, default=16,
        help="warm serving: max concurrent requests folded into one dispatch",
    )
    common.add_argument(
        "--serve-window-ms", type=float, default=5.0,
        help="warm serving: the batching window the coalescer leader waits before each "
        "drain (0 disables)",
    )
    common.add_argument(
        "--progress-chunks", type=int, default=4,
        help="chunks per epoch for batch-granular progress (1 = one progress write an epoch)",
    )

    p = sub.add_parser("train", parents=[common])
    p.add_argument("--name", required=True)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument(
        "--artifact-every", type=int, default=1,
        help="write figures/diagram every N epochs (the last epoch always writes)",
    )
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("generate", parents=[common])
    p.add_argument("--model", required=True)
    p.add_argument("--sharpen", action="store_true")
    p.add_argument("--num-reads", type=int, default=None)
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("tune", parents=[common])
    p.add_argument("--model", required=True)
    p.add_argument("--epochs", type=int, default=5)
    p.set_defaults(fn=cmd_tune)

    p = sub.add_parser("refresh", parents=[common])
    p.add_argument("--model", required=True)
    p.set_defaults(fn=cmd_refresh)

    p = sub.add_parser("tune-pt", parents=[common])
    p.add_argument("--model", required=True)
    p.add_argument("--iters", type=int, default=3, help="equal-barrier feedback iterations")
    p.add_argument("--chains", type=int, default=256, help="measurement chains per ladder rung")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_tune_pt)

    p = sub.add_parser("models")
    p.set_defaults(fn=cmd_models)
    return ap


def validate_extra_cli(extra_cli):
    """Fail fast on a mistyped pass-through flag: every ``--flag`` must be
    an option of some CLI subcommand."""
    ap = build_parser()
    known = set()
    for act in ap._actions:
        known.update(act.option_strings)
        if isinstance(act, argparse._SubParsersAction):
            for sub in act.choices.values():
                for a in sub._actions:
                    known.update(a.option_strings)
    bad = sorted({
        t.split("=", 1)[0]
        for t in extra_cli
        if t.startswith("--") and t.split("=", 1)[0] not in known
    })
    if bad:
        raise SystemExit(
            f"unknown flag(s) {' '.join(bad)}: not an app flag and not recognized by any "
            "image_generation_tpu_torch CLI command (the pass-through surface)"
        )


def parse_serving_args(extra_cli):
    """Parse a per-job ``extra_cli`` flag list as a ``generate`` invocation
    (unknown train-only flags tolerated), so in-process serving builds its
    trainer from the same config a CLI job gets."""
    args, _unknown = build_parser().parse_known_args(
        ["generate", "--model", "_"] + list(extra_cli)
    )
    return args


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    args.fn(args)
    print(f"done in {time.perf_counter() - t0:.1f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
