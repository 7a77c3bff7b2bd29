"""Mesh construction and read/candidate-sharded likelihood evaluation.

Counterpart of ``dbgphmm_tpu/parallel/sharding.py``, with the same layout:

* mesh axes ``("cand", "reads")``: candidate copy-number assignments x read
  batches, over a ``[C, R]`` grid of torch devices;
* graph / transition arrays replicated, one copy per distinct device;
* read arrays split along ``reads`` (or flat over every mesh device);
* candidate arrays split along ``cand``;
* per-shard results gathered to the host in mesh order.  Within one
  process that is a device-to-host copy of each block; across
  ``torch.distributed`` ranks (``parallel.multihost``) each rank computes
  the shards whose devices it holds and the blocks are all-gathered over
  gloo, so that every rank ends the call with the same full array.

An entry point given no mesh runs on the 1 x 1 mesh of its device
(:func:`local_mesh`), through the same code.  A mesh may name one device
more than once (``make_mesh(devices=[cuda:0] *
4)``): its shards then run one after another on that device.  In one
process the shards of a mesh are issued by one host thread, so a mesh
scales the work of single launches (the scorer kernels); the launch-bound
decode loops scale with one rank per GPU (``--dist``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.forward import DeviceModel, forward_scores
from ..ops.sparse import forward_scores_mapped

AXES = ("cand", "reads")


def _world() -> int:
    """The number of torch.distributed ranks (1 when none is initialised)."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _device(d) -> torch.device:
    """``d`` as a torch.device; a CUDA device without an index gets the
    current one, so that equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A ``("cand", "reads")`` grid of torch devices.

    ``devices`` is a [C, R] numpy object array of ``torch.device``.
    ``ranks`` is None for a mesh of this process's devices, or a [C, R]
    int array naming the torch.distributed rank that holds each device (a
    mesh across ranks: :func:`make_mesh` under ``--dist``,
    :func:`~dbgphmm_tpu_torch.parallel.multihost.global_mesh`).  Shard i
    of the flat order is ``devices.flat[i]`` (cand-major)."""

    axis_names = AXES

    def __init__(self, devices, ranks=None):
        given = np.asarray(devices, dtype=object)
        shape = given.shape
        flat = [_device(d) for d in given.ravel()]
        grid = np.empty(len(flat), dtype=object)
        grid[:] = flat
        if len(shape) != 2:
            raise ValueError(f"a mesh is a [C, R] grid of devices, got shape {shape}")
        if len({d.type for d in flat}) > 1:
            raise ValueError(f"a mesh's devices are of one type: {sorted(map(str, flat))}")
        self.devices = grid.reshape(shape)
        self.ranks = None if ranks is None else np.asarray(ranks, dtype=np.int64
                                                           ).reshape(shape)

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    @property
    def is_global(self) -> bool:
        """True for a mesh across torch.distributed ranks."""
        return self.ranks is not None

    def owns(self, i: int) -> bool:
        """Whether this process holds the device of flat shard ``i``."""
        return self.ranks is None or int(self.ranks.flat[i]) == _rank()

    def owned_devices(self) -> List[torch.device]:
        """The distinct devices of this process's shards, in mesh order."""
        out = []
        for i, d in enumerate(self.devices.flat):
            if self.owns(i) and d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def local_mesh(device) -> Mesh:
    """The 1 x 1 mesh of ``device``: what the sharded entry points run on
    when no mesh is given."""
    return Mesh(np.full((1, 1), torch.device(device), dtype=object))


def _local_devices(device: torch.device, n: Optional[int]) -> List[torch.device]:
    """The first ``n`` devices of this process of ``device``'s type: CUDA
    devices by index, ``n`` copies of the CPU."""
    if device.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n is None else n
        if n > count:
            raise ValueError(f"a mesh of {n} CUDA devices was asked for, but "
                             f"{count} are visible")
        return [torch.device("cuda", j) for j in range(n)]
    if device.type != "cpu":
        raise ValueError(f"a mesh runs on cpu or cuda devices, not {device}")
    return [torch.device("cpu")] * (1 if n is None else n)


def make_mesh(n_devices: Optional[int] = None, cand_axis: int = 1,
              device="cuda", devices: Optional[Sequence] = None) -> Mesh:
    """A ``("cand", "reads")`` mesh of ``n_devices`` devices, reshaped
    ``(cand_axis, n_devices // cand_axis)``.

    On CUDA the first ``n_devices`` visible GPUs (default: all); more than
    ``torch.cuda.device_count()`` is an error.  On the CPU ``n_devices``
    copies of ``cpu`` (default 1).  ``devices`` passes the devices
    explicitly (they may repeat).  Under torch.distributed with more than
    one rank (and no ``devices``) the mesh spans every rank's devices,
    rank-major (:func:`~dbgphmm_tpu_torch.parallel.multihost.global_mesh`)."""
    ranks = None
    if devices is not None:
        devs = [_device(d) for d in devices]
        n_devices = len(devs) if n_devices is None else n_devices
        if n_devices > len(devs):
            raise ValueError(f"a mesh of {n_devices} devices from {len(devs)}")
        devs = devs[:n_devices]
    elif _world() > 1:
        from .multihost import global_devices

        devs, ranks = global_devices(torch.device(device), n_devices)
    else:
        devs = _local_devices(torch.device(device), n_devices)
    n = len(devs)
    if n == 0 or n % cand_axis:
        raise ValueError(f"{n} devices do not split into {cand_axis} candidate rows")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    shape = (cand_axis, n // cand_axis)
    return Mesh(grid.reshape(shape), None if ranks is None
                else np.asarray(ranks).reshape(shape))


def mesh_read_axis_size(mesh: Mesh, flat: bool = False) -> int:
    """Number of shards along the read axis.  ``flat=True`` counts the whole
    mesh (read-only workloads shard over every device)."""
    if flat:
        return mesh.shape["cand"] * mesh.shape["reads"]
    return mesh.shape["reads"]


def _block(arr: np.ndarray, axis: int, lo: int, hi: int) -> np.ndarray:
    return np.ascontiguousarray(arr[(slice(None),) * axis + (slice(lo, hi),)])


def put_read_sharded(mesh: Mesh, arr, axis: int, flat: bool = True) -> list:
    """``arr`` split along its read axis, one block per mesh shard, as a
    list in mesh order: over every device when ``flat``, else over the
    "reads" axis only (shard (c, r) holds block r).  A block goes to each
    distinct device once; shards another rank holds are None.  The read
    dimension must already be padded to a multiple of the shard count."""
    a = np.asarray(arr)
    n = mesh_read_axis_size(mesh, flat)
    if a.shape[axis] % n:
        raise ValueError(f"read axis of {a.shape[axis]} is not padded to a "
                         f"multiple of {n} shards")
    per = a.shape[axis] // n
    R = mesh.shape["reads"]
    out, sent = [], {}
    for i, dev in enumerate(mesh.devices.flat):
        if not mesh.owns(i):
            out.append(None)
            continue
        b = i if flat else i % R
        if (b, dev) not in sent:
            sent[b, dev] = torch.as_tensor(_block(a, axis, b * per,
                                                  (b + 1) * per)).to(dev)
        out.append(sent[b, dev])
    return out


def _tree_to(tree, dev: torch.device):
    """``tree`` (tensors, numpy arrays, dataclasses, tuples, lists, dicts)
    with every array on ``dev``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree).to(dev)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_to(getattr(tree, f.name), dev)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_to(x, dev) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(x, dev) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree


def put_replicated(mesh: Mesh, tree) -> list:
    """``tree`` on every shard's device, as a list in mesh order: one copy
    per distinct device (a mesh that repeats a device uploads once),
    None for shards another rank holds."""
    copies, out = {}, []
    for i, dev in enumerate(mesh.devices.flat):
        if not mesh.owns(i):
            out.append(None)
            continue
        if dev not in copies:
            copies[dev] = _tree_to(tree, dev)
        out.append(copies[dev])
    return out


def gather_to_host(blocks: Sequence, mesh: Optional[Mesh] = None
                   ) -> List[np.ndarray]:
    """Per-shard blocks -> numpy, in the same order.  ``blocks`` holds a
    tensor (copied to the host), a numpy array (kept) or None (a block
    another rank computed) per position; every rank passes a list of the
    same length.  Under a mesh across ranks with a world size above 1 the
    blocks are all-gathered over the gloo group, so that every rank
    returns every block; launch every shard before calling this, so that
    the copies wait on all of them at once."""
    local = {}
    for i, b in enumerate(blocks):
        if isinstance(b, torch.Tensor):
            local[i] = b.detach().cpu().numpy()
        elif b is not None:
            local[i] = np.asarray(b)
    if mesh is not None and mesh.is_global and _world() > 1:
        parts = [None] * _world()
        torch.distributed.all_gather_object(parts, local)
        for part in parts:
            for i, b in part.items():
                local.setdefault(i, b)
    missing = [i for i in range(len(blocks)) if i not in local]
    if missing:
        raise RuntimeError(f"no rank computed the blocks {missing[:8]}")
    return [local[i] for i in range(len(blocks))]


def agree_min(value: int, mesh: Optional[Mesh] = None) -> int:
    """The least of every rank's ``value`` under a mesh across ranks (each
    rank's own value otherwise): how ranks agree on a host decision taken
    from their own device, so that they keep running the same program."""
    if mesh is not None and mesh.is_global and _world() > 1:
        parts = [None] * _world()
        torch.distributed.all_gather_object(parts, value)
        return min(parts)
    return value


def _pad_to_multiple(arr: np.ndarray, m: int, axis: int, fill):
    n = arr.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def forward_total(dms: Sequence, codes: Sequence, lens: Sequence,
                  mesh: Mesh) -> float:
    """Sum of the per-read forward scores over the shards (lists in mesh
    order, None where another rank holds the shard); reads of length 0
    (padding) are masked out."""
    parts = []
    for dm, c, ln in zip(dms, codes, lens):
        if c is None:
            parts.append(None)
            continue
        s = forward_scores(dm, c, ln, renorm=True)
        parts.append(torch.where(ln > 0, s, 0.0).sum().to(torch.float64))
    return float(np.sum(gather_to_host(parts, mesh)))


def sharded_forward_total(dm: DeviceModel, codes: np.ndarray,
                          lens: np.ndarray, mesh: Mesh) -> float:
    """Total log P(R | model) with reads sharded over every mesh device.

    Pads the read batch to a multiple of the mesh size with zero-length
    reads (code -1), which are masked out of the sum."""
    n = mesh.size
    codes = _pad_to_multiple(np.asarray(codes), n, 0, -1)
    lens = _pad_to_multiple(np.asarray(lens), n, 0, 0)
    return forward_total(put_replicated(mesh, dm), put_read_sharded(mesh, codes, 0),
                         put_read_sharded(mesh, lens, 0), mesh)


def candidate_per_read(base: DeviceModel, rows: dict, codes: np.ndarray,
                       lens: np.ndarray, mesh: Mesh,
                       map_nodes: Optional[np.ndarray] = None) -> np.ndarray:
    """[Cp, B] float64 per-read log-likelihoods of stacked candidates.

    ``rows`` maps init_logp / parent_logt / child_logt to [Cp, ...] host
    tensors, Cp a multiple of the "cand" axis, and is split along it;
    ``base`` (the shared topology) is replicated; the reads (and the
    ``map_nodes`` of the mapped forward) split along "reads", padded with
    zero-length reads whose columns are dropped.  Every shard is launched
    before the blocks are gathered."""
    n_cs, n_rs = mesh.shape["cand"], mesh.shape["reads"]
    B = codes.shape[0]
    per = rows["init_logp"].shape[0] // n_cs
    put_r = lambda a, fill: put_read_sharded(
        mesh, _pad_to_multiple(np.asarray(a), n_rs, 0, fill), 0, flat=False)
    codes_b, lens_b = put_r(codes, -1), put_r(lens, 0)
    mn_b = [None] * mesh.size if map_nodes is None else put_r(map_nodes, -1)
    bases = put_replicated(mesh, base)
    blocks = []
    for i, dev in enumerate(mesh.devices.flat):
        if bases[i] is None:
            blocks.append(None)
            continue
        g = i // n_rs
        dm = dataclasses.replace(bases[i], **{
            f: t[g * per:(g + 1) * per].to(dev).unsqueeze(1)  # [per, 1, n(, D)]
            for f, t in rows.items()})
        if mn_b[i] is None:
            blocks.append(forward_scores(dm, codes_b[i], lens_b[i]))
        else:
            blocks.append(forward_scores_mapped(dm, codes_b[i], lens_b[i], mn_b[i]))
    got = gather_to_host(blocks, mesh)
    return np.concatenate([
        np.concatenate(got[g * n_rs:(g + 1) * n_rs], axis=1) for g in range(n_cs)
    ]).astype(np.float64)[:, :B]


def sharded_candidate_log_likelihoods(dms: Sequence[DeviceModel],
                                      codes: np.ndarray, lens: np.ndarray,
                                      mesh: Mesh) -> np.ndarray:
    """[n_candidates] total log-likelihoods with candidates split along
    ``cand`` (padded to a multiple of its size with copies of the first)
    and reads along ``reads`` (padded with zero-length reads, dropped).

    All candidates share topology (emission, parent_idx, child_idx); only
    init_logp, parent_logt and child_logt differ."""
    C = len(dms)
    per = -(-C // mesh.shape["cand"])
    dms = list(dms) + [dms[0]] * (per * mesh.shape["cand"] - C)
    rows = {f: torch.stack([getattr(d, f).cpu() for d in dms])
            for f in ("init_logp", "parent_logt", "child_logt")}
    return candidate_per_read(dms[0], rows, np.asarray(codes), np.asarray(lens),
                              mesh).sum(axis=1)[:C]
