"""Multi-process launch: ``torch.distributed`` initialisation, per-rank read
slicing, and read-sharded scoring across ranks.

Counterpart of ``dbgphmm_tpu/parallel/multihost.py``.  Every rank (one
process, typically one GPU pinned by ``CUDA_VISIBLE_DEVICES``) holds the
small graph replicated, computes the shards whose devices it holds, and
the per-shard results are all-gathered over a gloo process group — the
only cross-rank exchange the algorithm needs (the JAX package, too, brings
every sharded result to the host).  The exchanged blocks are small host
arrays (a [C, B] score block is at most a few MB), so no device-resident
collective is used, and two ranks may share one GPU.

Launch recipe (one command per rank; ``',,'`` reads torchrun's
MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK instead):

    # rank 0
    CUDA_VISIBLE_DEVICES=0 python -m dbgphmm_tpu_torch \\
        --dist localhost:12345,2,0 --mesh 1x2 sample ...
    # rank 1
    CUDA_VISIBLE_DEVICES=1 python -m dbgphmm_tpu_torch \\
        --dist localhost:12345,2,1 --mesh 1x2 sample ...

The invariant: every rank runs the same host program (graph operations,
flow solver and neighbour generation are deterministic) and ends each
sharded call with the same full array, so the float64 sums, the hill
climb and the files written are identical on every rank.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from .sharding import (
    Mesh,
    _pad_to_multiple,
    _rank,
    _world,
    forward_total,
    put_read_sharded,
    put_replicated,
)

DIST_TIMEOUT_S = 1800  # seconds; gloo's own default, made explicit


def collective_timeout() -> datetime.timedelta:
    """How long a rank waits in a collective (and for the group to form)
    before it fails: ``DBGPHMM_DIST_TIMEOUT_S`` seconds, default
    DIST_TIMEOUT_S.  Ranks meet at every sharded call, so the wait must
    outlast the longest stretch of work between two of them on the
    slowest rank (a decode pass of one read chunk); a rank whose peer
    died or hung fails after it."""
    return datetime.timedelta(seconds=float(
        os.environ.get("DBGPHMM_DIST_TIMEOUT_S", DIST_TIMEOUT_S)))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the gloo process group: ``coordinator_address`` host:port of
    rank 0, the number of processes and this process's rank.  With no
    arguments the group is read from torchrun's environment variables
    (``init_method="env://"``).  Collectives time out after
    :func:`collective_timeout`."""
    dist = torch.distributed
    if coordinator_address is None and num_processes is None and process_id is None:
        dist.init_process_group("gloo", init_method="env://",
                                timeout=collective_timeout())
    else:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=collective_timeout())


def parse_dist_arg(spec: str) -> Tuple[str, int, int]:
    """``"host:port,n_processes,process_id"`` -> tuple."""
    addr, n, i = spec.rsplit(",", 2)
    return addr, int(n), int(i)


def global_devices(device: torch.device, n_devices: Optional[int] = None
                   ) -> Tuple[List[torch.device], List[int]]:
    """(devices, ranks) of every rank, rank-major: on CUDA each rank's
    visible GPUs (their counts are all-gathered), the first ``n_devices``
    of them (default all; more is an error); on the CPU ``n_devices``
    copies of the CPU (default one per rank), split into equal runs of
    consecutive shards per rank."""
    world = _world()
    if device.type == "cuda":
        counts = [None] * world
        if world > 1:
            torch.distributed.all_gather_object(counts, torch.cuda.device_count())
        else:
            counts = [torch.cuda.device_count()]
        pairs = [(torch.device("cuda", j), r) for r in range(world)
                 for j in range(counts[r])]
        n = len(pairs) if n_devices is None else n_devices
        if n > len(pairs):
            raise ValueError(f"a mesh of {n} CUDA devices was asked for, but "
                             f"{len(pairs)} are visible across {world} rank(s) "
                             f"({counts})")
        pairs = pairs[:n]
        return [d for d, _r in pairs], [r for _d, r in pairs]
    if device.type != "cpu":
        raise ValueError(f"a mesh runs on cpu or cuda devices, not {device}")
    n = world if n_devices is None else n_devices
    per = -(-n // world)
    return [torch.device("cpu")] * n, [i // per for i in range(n)]


def global_mesh(cand_axis: int = 1, device="cuda") -> Mesh:
    """("cand", "reads") mesh over every device of every rank (on the CPU,
    one per rank), rank-major, reshaped ``(cand_axis, n // cand_axis)``.
    The "reads" axis spans ranks; candidate rows stay within a rank when
    ``cand_axis`` divides its device count."""
    devs, ranks = global_devices(torch.device(device))
    n = len(devs)
    if n % cand_axis:
        raise ValueError(f"{n} devices do not split into {cand_axis} candidate rows")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    shape = (cand_axis, n // cand_axis)
    return Mesh(grid.reshape(shape), np.asarray(ranks).reshape(shape))


def process_read_slice(n_reads: int, mesh: Mesh) -> slice:
    """Contiguous slice of the (padded) read batch owned by this rank.

    The global read axis is laid out shard-major in mesh order, which
    enumerates ranks in order — so each rank owns one contiguous block of
    the padded batch."""
    n_dev = mesh.size
    n_pad = -(-n_reads // n_dev) * n_dev
    per_proc = n_pad // _world()
    i = _rank()
    return slice(i * per_proc, (i + 1) * per_proc)


def put_read_sharded_global(mesh: Mesh, global_arr: np.ndarray, axis: int,
                            fill=0) -> list:
    """``global_arr`` padded with ``fill`` and split along ``axis`` over
    every device of the mesh; only this rank's blocks are read and
    uploaded (None elsewhere), so a rank may pass an array whose other
    blocks are padding."""
    arr = _pad_to_multiple(np.asarray(global_arr), mesh.size, axis, fill)
    return put_read_sharded(mesh, arr, axis, flat=True)


def put_replicated_global(mesh: Mesh, tree) -> list:
    """``tree`` on every device this rank holds (every rank passes the same
    values); None for the other ranks' shards."""
    return put_replicated(mesh, tree)


def distributed_forward_total(dm, codes: np.ndarray, lens: np.ndarray,
                              mesh: Mesh) -> float:
    """Total log P(R | model) with reads sharded over every rank's devices.
    Every rank passes the same logical (global) codes / lens — or arrays
    whose blocks of other ranks are padding — and returns the same total."""
    return forward_total(put_replicated_global(mesh, dm),
                         put_read_sharded_global(mesh, codes, 0, fill=-1),
                         put_read_sharded_global(mesh, lens, 0, fill=0), mesh)
