"""Multi-rank dry runs: the mesh's correctness gates on N ranks.

Port of the JAX package's two dry runs, ``__graft_entry__.py``
``dryrun_multichip`` (one program over N devices) and
``scripts/dryrun_multihost.py`` (two processes of four devices joining one
mesh).  Here every rank is a process: ``--ranks N`` spawns N of them,
joined by gloo over ``tcp://127.0.0.1`` into one world, each on the card
(``cuda:<rank mod cards>``) unless ``--platform cpu``; ``--hosts 2`` makes
two launcher processes of N/2 ranks each, which join the one world as the
JAX script's two processes do.  Every rank builds the JAX default mesh
(``create_mesh``: (N/2, 2) for an even N) over the 32-latent Zephyr(3)
subgraph the JAX dry run trains, and runs the checks by the JAX names:

  * ``chain_sharded_epoch``: two data-parallel steps with the chains split
    over the mesh, fed the draws of one process, against one process
    (MSE rtol 1e-4, loss rtol 1e-3: the JAX gate's and the sharded-step
    tolerances of ``tests/test_torch_data_axis.py``);
  * ``pt_step``: a PT step with the N-rung ladder over the ranks;
  * ``chain_sharded_sweep``: the chain-sharded sweep fed uniforms, bit
    for bit against the one-device sweep;
  * ``graph_sharded_step``: graph-sharded steps, plain and PT, with the
    same DVAE draws as one process, MSE rtol 1e-4; an int8 and a
    block-sparse one (chunk 64), the latter's MSE too;
  * ``k4_philox_row_split``: K4's Philox draws do not depend on how the
    chain rows are split (the port's ``plrng_row_seed_bit_exact``): the
    graph-sharded sweep with the rows split over ``data`` equals, bit for
    bit, the sweep of the whole rows;
  * ``column_sharded_dense``: a step with the decoder's dense layer
    column-sharded (``dense_min_elems=4096``) against the replicated
    step in one process (MSE 1e-4, loss 1e-3, the layer 5e-4).

It prints one summary line, writes every rank's results as JSON to
``--out`` (when given; never into ``runs/``), and exits non-zero when a
check failed or a rank raised.

    python -m image_generation_tpu_torch.parallel.dryrun --ranks 4 [--hosts 2] \\
        [--platform cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import copy
import json
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

__all__ = ["main", "run_checks", "base_config"]

TIMEOUT_S = 300  # a collective's limit
MSE_RTOL, LOSS_RTOL, PARAMS_ATOL = 1e-4, 1e-3, 5e-4


def base_config(world: int, **kw):
    """The JAX dry run's ``_base_cfg``: 32 latents, chains and batch that
    tile the world, f32 end to end (so the sharded and one-process
    trajectories agree to rounding)."""
    from image_generation_tpu_torch.config import TrainingConfig

    return TrainingConfig(N_LATENTS=32, NUM_READS=8 * world, BATCH_SIZE=2 * world, N_REPLICAS=2,
                          GIBBS_SWEEPS=2, GIBBS_BURN_IN=2, COMPUTE_DTYPE="float32",
                          SAMPLER_MATMUL_DTYPE="float32", **kw)


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _launches() -> dict:
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda
    from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import span_update

    return {**gibbs_cuda.gibbs_sweeps_cuda.launches,
            **gibbs_hbm_cuda.gibbs_sweeps_hbm_cuda.launches, **span_update.launches}


class _Checks:
    """The checks on one rank (the module docstring); each records its
    numbers and whether it held."""

    def __init__(self, mesh, device):
        from image_generation_tpu_torch.ops.gibbs import build_plan
        from image_generation_tpu_torch.utils.graph_cache import graph_from_topology
        from image_generation_tpu_torch.utils.subgraph import select_latent_graph
        from image_generation_tpu_torch.utils.topology import zephyr_graph

        self.mesh, self.device, self.world = mesh, torch.device(device), mesh.size
        self.cfg = base_config(self.world)
        latent, _ = select_latent_graph(zephyr_graph(3), 32, self.cfg.RANDOM_SEED)
        self.graph = graph_from_topology(latent)
        self.plan = build_plan(self.graph)
        self.results: dict = {}

    def images(self, seed: int, batch: int) -> torch.Tensor:
        return torch.rand((batch, 32, 32, 1), generator=_gen(seed, self.device),
                          device=self.device).round()

    def twins(self, cfg, seed: int, dense_min_elems=None):
        """(fns, state) on the mesh and in one process (not graph-sharded:
        one device has no graph axis) from the same weights, GRBM, chains
        and generator seed."""
        from image_generation_tpu_torch.models.grbm import GRBMParams
        from image_generation_tpu_torch.training.step import _flax_init_, make_train_fns

        dev = self.device
        fns_m = make_train_fns(cfg, self.graph, 4, self.plan, device=dev, mesh=self.mesh,
                               dense_min_elems=dense_min_elems)
        fns_1 = make_train_fns(cfg.replace(GRAPH_SHARDED="off"), self.graph, 4, self.plan,
                               device=dev)
        dvae = fns_1.new_dvae()
        _flax_init_(dvae, torch.Generator().manual_seed(seed))
        grbm = self.graph.init_params(_gen(seed, dev), device=dev)
        chains = fns_1.new_chains(_gen(seed + 1, dev))
        st_m = fns_m.state_from(copy.deepcopy(dvae), GRBMParams(grbm.linear.clone(),
                                                                grbm.quadratic.clone()),
                                chains, _gen(seed + 2, dev), burn_in=False)
        st_1 = fns_1.state_from(dvae, grbm, chains, _gen(seed + 2, dev), burn_in=False)
        return (fns_m, st_m), (fns_1, st_1)

    def feed(self, cfg, seed: int, sweeps: bool):
        """The draws of one step for the global batch (and, with
        ``sweeps``, plain Gibbs's sweep uniforms), the same on every rank."""
        from image_generation_tpu_torch.models.decoder import draw_dropout_masks
        from image_generation_tpu_torch.training.step import StepFeed

        g, dev = _gen(seed, self.device), self.device
        shape = (cfg.GIBBS_SWEEPS, cfg.NUM_READS, self.plan.n_pad)
        s1 = torch.rand(shape, generator=g, device=dev) if sweeps else None
        s2 = torch.rand(shape, generator=g, device=dev) if sweeps else None
        return StepFeed(sweeps1=s1, sweeps2=s2, spin_uniforms=torch.rand(
            (cfg.BATCH_SIZE, cfg.N_REPLICAS, cfg.N_LATENTS), generator=g, device=dev),
            dropout_masks=draw_dropout_masks(cfg.BATCH_SIZE * cfg.N_REPLICAS, g, dev))

    def record(self, name: str, ok: bool, **numbers) -> None:
        self.results[name] = dict(ok=bool(ok), **numbers)

    @staticmethod
    def close(a: float, b: float, rtol: float) -> bool:
        return abs(a - b) <= rtol * abs(b)

    # ---- the checks ------------------------------------------------------
    def chain_sharded_epoch(self) -> None:
        (fns_m, st_m), (fns_1, st_1) = self.twins(self.cfg, 1)
        assert fns_m.sampler_impl.endswith("_sharded"), fns_m.sampler_impl
        mse, loss = [], []
        for i in range(2):
            images = self.images(10 + i, self.cfg.BATCH_SIZE)
            feed = self.feed(self.cfg, 20 + i, sweeps=True)
            mm = fns_m.step_body(st_m, images, 0, feed)
            m1 = fns_1.step_body(st_1, images, 0, feed)
            mse.append([float(mm.mse), float(m1.mse)])
            loss.append([float(mm.dvae_loss), float(m1.dvae_loss)])
        ok = all(self.close(a, b, MSE_RTOL) for a, b in mse) and all(
            self.close(a, b, LOSS_RTOL) for a, b in loss) and np.isfinite(mse).all()
        self.record("chain_sharded_epoch", ok, impl=fns_m.sampler_impl, mse=mse, loss=loss)

    def pt_step(self) -> None:
        from image_generation_tpu_torch.training.step import make_train_fns

        cfg = self.cfg.replace(SAMPLER="pt", PT_NUM_BETAS=self.world, NUM_READS=8)
        fns = make_train_fns(cfg, self.graph, 4, self.plan, device=self.device, mesh=self.mesh)
        st = fns.init(3)
        m = fns.step_body(st, self.images(2, cfg.BATCH_SIZE), 0)
        ladder = list(st.chains.shape)
        ok = np.isfinite(float(m.mse)) and ladder[0] * fns.train_rows.n == self.world
        self.record("pt_step", ok, mse=float(m.mse), ladder=ladder, impl=fns.sampler_impl)

    def chain_sharded_sweep(self) -> None:
        from image_generation_tpu_torch.models.grbm import GRBMParams
        from image_generation_tpu_torch.ops.gibbs import random_spins
        from image_generation_tpu_torch.training.step import make_sample_fns

        dev, c, n_sweeps = self.device, 8 * self.world, 3
        fns_m = make_sample_fns(self.cfg, self.graph, self.plan, device=dev, mesh=self.mesh)
        fns_1 = make_sample_fns(self.cfg, self.graph, self.plan, device=dev)
        g = _gen(4, dev)
        params = GRBMParams(0.1 * torch.randn(self.graph.n, generator=g, device=dev),
                            0.2 * torch.randn(self.graph.n_edges, generator=g, device=dev))
        hp, cp = fns_1.build_sampler_model(params)
        s0 = random_spins(g, self.plan, c, dev)
        u = torch.rand((n_sweeps, c, self.plan.n_pad), generator=g, device=dev)
        rows = fns_m.row_shard(c)
        part = fns_m.sweeps_fn(None, hp, cp, fns_m.local(s0, rows), n_sweeps, uniforms=u,
                               rows=rows)
        sharded = fns_m.unlocal(part, rows)
        single = fns_1.sweeps_fn(None, hp, cp, s0, n_sweeps, uniforms=u)
        self.record("chain_sharded_sweep", torch.equal(sharded, single), chains=c,
                    impl=fns_m.sampler_impl, rows=list(part.shape))

    def _gs_mse(self, cfg, seed: int):
        """(mesh MSE, one-process MSE, impl) of one graph-sharded step
        with the same DVAE draws on both sides."""
        (fns_m, st_m), (fns_1, st_1) = self.twins(cfg, seed)
        assert fns_m.graph_sharded, fns_m.sampler_impl
        images = self.images(5, cfg.BATCH_SIZE)
        feed = self.feed(cfg, 30 + seed, sweeps=False)
        mm = fns_m.step_body(st_m, images, 0, feed)
        m1 = fns_1.step_body(st_1, images, 0, feed)
        return float(mm.mse), float(m1.mse), float(mm.dvae_loss), fns_m.sampler_impl

    def graph_sharded_step(self) -> None:
        gs = self.cfg.replace(GRAPH_SHARDED="on")
        plain = self._gs_mse(gs, 6)
        pt = self._gs_mse(gs.replace(SAMPLER="pt", PT_NUM_BETAS=self.world, NUM_READS=8), 7)
        i8 = self._gs_mse(gs.replace(SAMPLER_MATMUL_DTYPE="int8"), 8)
        bs = self._gs_mse(gs.replace(SWEEP_BLOCK_SPARSE="on", SWEEP_BS_CHUNK=64), 6)
        ok = (self.close(plain[0], plain[1], MSE_RTOL) and self.close(pt[0], pt[1], MSE_RTOL)
              and self.close(bs[0], bs[1], MSE_RTOL) and np.isfinite(i8[2])
              and "+int8" in i8[3] and bs[3].endswith("+bs"))
        self.record("graph_sharded_step", ok, plain=plain, pt=pt, int8=i8, block_sparse=bs)

    def k4_philox_row_split(self) -> None:
        from image_generation_tpu_torch.models.grbm import GRBMParams
        from image_generation_tpu_torch.ops.gibbs import random_spins
        from image_generation_tpu_torch.ops.gibbs_graph_sharded import gibbs_sweeps_graph_sharded
        from image_generation_tpu_torch.training.step import RowShard, make_sample_fns

        dev, c = self.device, 2 * self.world
        fns = make_sample_fns(self.cfg.replace(GRAPH_SHARDED="on"), self.graph, self.plan,
                              device=dev, mesh=self.mesh)
        g = _gen(11, dev)
        params = GRBMParams(0.1 * torch.randn(self.graph.n, generator=g, device=dev),
                            0.2 * torch.randn(self.graph.n_edges, generator=g, device=dev))
        hp, cp = fns.build_sampler_model(params)
        s0 = random_spins(g, self.plan, c, dev)
        rows = fns.row_shard(c)
        part = fns.local(s0, rows)
        split = gibbs_sweeps_graph_sharded(hp, cp, self.plan, part, 3, self.mesh,
                                           generator=_gen(12, dev),
                                           row0=rows.index * part.shape[0])
        whole = gibbs_sweeps_graph_sharded(hp, cp, self.plan, fns.local(s0, RowShard()), 3,
                                           self.mesh, generator=_gen(12, dev), row0=0)
        split_all = fns.unlocal(split, rows)
        whole_all = self.mesh.all_gather(whole, dim=-1)
        self.record("k4_philox_row_split", torch.equal(split_all, whole_all),
                    rows_split_over=list(rows.axes), impl=fns.sampler_impl)

    def column_sharded_dense(self) -> None:
        from image_generation_tpu_torch.parallel.dense import (
            ColumnShardedLinear,
            gather_large_dense,
        )

        (fns_m, st_m), (fns_1, st_1) = self.twins(self.cfg, 13, dense_min_elems=4096)
        layer = st_m.dvae._decoder.increase_latent_dim
        images = self.images(14, self.cfg.BATCH_SIZE)
        feed = self.feed(self.cfg, 15, sweeps=True)
        mm = fns_m.step_body(st_m, images, 0, feed)
        m1 = fns_1.step_body(st_1, images, 0, feed)
        key = "_decoder.increase_latent_dim.weight"
        w_err = float((gather_large_dense(st_m.dvae)[key]
                       - st_1.dvae.state_dict()[key]).abs().max())
        ok = (isinstance(layer, ColumnShardedLinear) and self.close(float(mm.mse), float(m1.mse),
                                                                    MSE_RTOL)
              and self.close(float(mm.dvae_loss), float(m1.dvae_loss), LOSS_RTOL)
              and w_err <= PARAMS_ATOL)
        self.record("column_sharded_dense", ok, rows=list(layer.weight.shape),
                    mse=[float(mm.mse), float(m1.mse)],
                    loss=[float(mm.dvae_loss), float(m1.dvae_loss)], layer_max_abs=w_err)

    def run(self) -> dict:
        for name in ("chain_sharded_epoch", "pt_step", "chain_sharded_sweep",
                     "graph_sharded_step", "k4_philox_row_split", "column_sharded_dense"):
            try:
                getattr(self, name)()
            except AssertionError as e:  # every rank ran the same collectives
                self.record(name, False, error=repr(e))
        return self.results


def run_checks(mesh, device) -> dict:
    """Every check on this rank of ``mesh`` (all ranks call it alike):
    {check: {"ok": ..., numbers}}."""
    return _Checks(mesh, device).run()


def _rank_main(local: int, base: int, world: int, port: int, platform: str, out_dir: str):
    import torch.distributed as dist

    from image_generation_tpu_torch.parallel.mesh import create_mesh

    rank = base + local
    if platform == "cpu":
        device = "cpu"
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        device = f"cuda:{torch.cuda.current_device()}"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=TIMEOUT_S))
    try:
        mesh = create_mesh(backend="gloo")
        t0 = time.perf_counter()
        results = run_checks(mesh, device)
        out = dict(rank=rank, mesh=list(mesh.shape), device=device, checks=results,
                   launches=_launches(), seconds=time.perf_counter() - t0,
                   comm_seconds=mesh.comm_seconds)
        (Path(out_dir) / f"rank_{rank}.json").write_text(json.dumps(out))
        mesh.barrier()
    finally:
        dist.destroy_process_group()


def _launch_local(host: int, ranks: int, hosts: int, port: int, platform: str,
                  out_dir: str) -> None:
    """This launcher's ranks, [host·N/H, (host+1)·N/H), as spawned
    processes; a rank's exception ends them all and raises here."""
    import torch.multiprocessing as mp

    per = ranks // hosts
    mp.start_processes(_rank_main, args=(host * per, ranks, port, platform, out_dir),
                       nprocs=per, join=True, start_method="spawn")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def summary(ranks: list) -> tuple:
    """(all checks held on every rank, the one-line summary)."""
    r0 = ranks[0]["checks"]
    failed = sorted({name for r in ranks for name, c in r["checks"].items() if not c["ok"]})
    eq = all(r["checks"]["chain_sharded_epoch"].get("mse") == r0["chain_sharded_epoch"].get("mse")
             for r in ranks)
    if not eq:
        failed.append("losses differ across ranks")
    g = r0["graph_sharded_step"]
    line = (
        f"mesh={tuple(ranks[0]['mesh'])} axes=('data', 'graph') ranks={len(ranks)} "
        f"device={ranks[0]['device']} "
        f"chain_sharded_epoch_mse={[m[0] for m in r0['chain_sharded_epoch'].get('mse', [])]} "
        f"single_device_match={r0['chain_sharded_epoch']['ok']} "
        f"pt_step_mse={r0['pt_step'].get('mse')} ladder={r0['pt_step'].get('ladder')} "
        f"chain_sharded_sweep_bit_exact={r0['chain_sharded_sweep']['ok']} "
        f"graph_sharded_mse_match={g['ok']} pt_graph_sharded_mse={g.get('pt', [None])[0]} "
        f"int8_graph_sharded_mse={g.get('int8', [None])[0]} "
        f"k4_philox_row_split_bit_exact={r0['k4_philox_row_split']['ok']} "
        f"column_sharded_dense_match={r0['column_sharded_dense']['ok']}"
    )
    if failed:
        return False, f"dryrun FAILED ({', '.join(failed)}): {line}"
    return True, f"dryrun ok: {line}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--hosts", type=int, default=1, choices=[1, 2])
    ap.add_argument("--platform", default=None, help="'cpu' runs on the CPU; default: the card")
    ap.add_argument("--out", default=None, help="write every rank's results here (JSON)")
    ap.add_argument("--timeout", type=int, default=600)
    # internal: one launcher of a --hosts run
    ap.add_argument("--launcher", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    platform = "cpu" if args.platform == "cpu" else "cuda"
    if args.ranks < 2 or args.ranks % args.hosts:
        raise SystemExit(f"--ranks must be >= 2 and a multiple of --hosts, got {args.ranks}")
    if args.launcher is not None:
        _launch_local(args.launcher, args.ranks, args.hosts, args.port, platform, args.dir)
        return 0
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card is visible: pass --platform cpu to run on the CPU")
        from image_generation_tpu_torch.ops.cuda_build import load_libraries

        load_libraries()  # built once here, loaded by every rank
    port, t0 = _free_port(), time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        if args.hosts == 1:
            _launch_local(0, args.ranks, 1, port, platform, tmp)
        else:
            cmd = [sys.executable, "-m", "image_generation_tpu_torch.parallel.dryrun",
                   "--ranks", str(args.ranks), "--hosts", str(args.hosts), "--platform",
                   platform, "--port", str(port), "--dir", tmp]
            procs = [subprocess.Popen(cmd + ["--launcher", str(h)]) for h in range(args.hosts)]
            rcs = []
            for p in procs:
                try:
                    rcs.append(p.wait(timeout=args.timeout))
                except subprocess.TimeoutExpired:
                    p.kill()
                    rcs.append(124)
            if any(rcs):
                print(f"dryrun FAILED: launcher exit codes {rcs}", flush=True)
                return 1
        ranks = [json.loads((Path(tmp) / f"rank_{r}.json").read_text())
                 for r in range(args.ranks)]
    ok, line = summary(ranks)
    report = dict(ok=ok, hosts=args.hosts, seconds=time.perf_counter() - t0, ranks=ranks)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(line, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
