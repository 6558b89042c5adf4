"""Rank 0 of a warm server on several gloo ranks, for the CPU tests.

``python tests/torch_warm_leader.py OUT_DIR WORKDIR MODEL OVERRIDES_JSON <flags>``
runs ``app.server.make_server(warm_generate=True)`` with the pass-through
``<flags>`` (e.g. ``--mesh 2x1 --platform cpu``), so this process becomes
rank 0 of a world and starts the followers.  It serves one dispatch of two
requests for ``MODEL``, shuts the server down, then starts a second server
and kills its follower before a dispatch.  It writes ``OUT_DIR/images.npy``
(the dispatch's uint8 images, (2, reads, S, S, 1)) and
``OUT_DIR/leader.json``: the world rank 0 was in, the followers' pids and
their reports at "stop", the seconds the first shutdown took, rank 0's
kernel launches by mode, and what the dispatch after the kill raised.
"""

import json
import os
import signal
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def main(out_dir: Path, workdir: str, model: str, overrides: dict, flags: list) -> None:
    import torch.distributed as dist

    from image_generation_tpu_torch.app import server
    from image_generation_tpu_torch.app.warm import _launch_counts, _Request

    srv = server.make_server(workdir, port=0, extra_cli=flags, warm_generate=True,
                             warm_overrides=overrides)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    warm = srv.warm
    world = dict(backend=dist.get_backend(), size=dist.get_world_size(), rank=dist.get_rank(),
                 mesh=list(warm.mesh.shape), device=str(warm.device))
    pids = warm.world.pids
    group = [_Request(model), _Request(model)]
    warm._run_group(group)
    np.save(out_dir / "images.npy", np.stack([r.result[0] for r in group]))
    launches = _launch_counts()
    t0 = time.monotonic()
    srv.shutdown()
    stop_s = time.monotonic() - t0
    srv.server_close()
    reports = warm.world.reports

    # a second server whose follower dies before its first dispatch
    srv = server.make_server(workdir, port=0, extra_cli=flags, warm_generate=True,
                             warm_overrides=overrides)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    killed = srv.warm.world.pids
    for pid in killed:
        os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + 10
    while any(p.is_alive() for p in srv.warm.world.procs) and time.monotonic() < deadline:
        time.sleep(0.05)
    errors = []
    for _ in range(2):  # this dispatch and the next
        try:
            srv.warm.serve(model)
            errors.append(None)
        except RuntimeError as e:
            errors.append(str(e))
    srv.shutdown()
    srv.server_close()
    (out_dir / "leader.json").write_text(json.dumps(dict(
        world=world, pids=pids, reports=reports, stop_s=stop_s, launches=launches,
        killed=killed, errors=errors,
        after=dist.is_initialized())))


if __name__ == "__main__":
    main(Path(sys.argv[1]), sys.argv[2], sys.argv[3], json.loads(sys.argv[4]), sys.argv[5:])
