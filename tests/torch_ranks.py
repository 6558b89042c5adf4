"""The port's mesh ranks as threads, for the CPU tests.

``run_ranks(n, fn, shape)`` runs ``fn(mesh)`` on ``n`` threads, each one
rank of a ``Mesh(shape)`` (``(1, n)`` by default) whose axis groups are
gloo process groups over one in-memory store: every data row's graph
group, every graph column's data group and the world group, as
``create_mesh`` makes them.

Each group's gloo device is the loopback interface (not the host name's
address, which may resolve to another interface), and no rank drops its
groups before every rank is done with them: each rank ends with a barrier
on its world group and the groups are held until every thread has
joined.  Without that a rank that ran no collective (a test of packing
alone) could tear its pairs down while another rank was still connecting
to it.
"""

import threading
import uuid
from datetime import timedelta

import torch.distributed as dist

from image_generation_tpu_torch.parallel.mesh import Mesh

TIMEOUT_S = 120  # a collective's limit; the threads are waited on longer


def _group(store, name: str, rank: int, size: int):
    opts = dist.ProcessGroupGloo._Options()
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    opts._timeout = timedelta(seconds=TIMEOUT_S)
    return dist.ProcessGroupGloo(dist.PrefixStore(name, store), rank, size, opts)


def run_ranks(n_ranks: int, fn, shape=None):
    """``fn(mesh)`` on ``n_ranks`` threads, rank r at (r // graph, r %
    graph) of a ``shape`` (default (1, n_ranks)) mesh; returns the results
    in rank order and re-raises the first failure."""
    shape = (1, n_ranks) if shape is None else tuple(shape)
    n_data, n_graph = shape
    assert n_data * n_graph == n_ranks
    store, prefix = dist.HashStore(), uuid.uuid4().hex
    out, errors, held = [None] * n_ranks, [], []

    def work(rank):
        d, g = divmod(rank, n_graph)
        try:
            world = _group(store, f"{prefix}/world", rank, n_ranks)
            groups = dict(world_group=world)
            if n_graph > 1:
                groups["graph_group"] = (world if n_data == 1 else
                                         _group(store, f"{prefix}/row{d}", g, n_graph))
            if n_data > 1:
                groups["data_group"] = (world if n_graph == 1 else
                                        _group(store, f"{prefix}/col{g}", d, n_data))
            held.append(groups)
            out[rank] = fn(Mesh(shape, data_index=d, graph_index=g, backend="gloo", **groups))
            world.barrier().wait()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(r,)) for r in range(n_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(2 * TIMEOUT_S)
    hung = any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    assert not hung, "a rank hung"
    held.clear()
    return out
