"""The rank grid, its process groups, and every collective the port issues.

Counterpart of ``dyglib_tpu/parallel/mesh.py``. The JAX package names a
2-D device mesh ``(data, model)`` and lets XLA's SPMD partitioner insert
the collectives; here one process drives one device, the grid is a grid
of ranks laid out as the JAX package lays out devices (rank r at data
index r // mp, model index r % mp), and each collective is spelled out
through the wrappers below.

  * ``data`` axis: chronological batches are split by rows
    (``batch_sharded``), parameter gradients summed, evaluation
    probabilities gathered, memory-model state sharded by node rows;
  * ``model`` axis: feature tables sharded by columns
    (``feature_sharded``, ``ColumnShardedTable``) and DyGFormer's
    Ulysses token/head flip.

Every wrapper counts its calls and the bytes this rank sends per call
site (``collective_counts``), as ``ops/_build.py::count_launch`` counts
kernel launches, and runs the call in a ``torch.profiler`` range
``mesh/<site>`` (``scripts/profile_torch_eval.py --mesh`` reads them).
A call recorded into a CUDA graph is counted once, when it is captured;
its replays are not. The differentiable ones
(``all_gather``, ``all_to_all``) are ``torch.autograd.Function``s whose
backward is the transposed collective (a summed gather, the inverse
all-to-all), counted under ``<site>:bwd``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from .distributed import host_batch_slice, process_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

_COUNTS: dict[str, list[int]] = {}


def collective_counts() -> dict[str, tuple[int, int]]:
    """{call site: (calls, bytes sent by this rank)} since the last reset."""
    return {site: (c[0], c[1]) for site, c in _COUNTS.items()}


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _count(site: str, nbytes: int) -> record_function:
    """Count one call at ``site`` and return its profiler range,
    ``mesh/<site>``, for the call to run in."""
    c = _COUNTS.setdefault(site, [0, 0])
    c[0] += 1
    c[1] += int(nbytes)
    return record_function(f"mesh/{site}")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a (data, model) grid of ranks, and the process
    groups of its row and column."""

    shape: tuple[int, int]  # (data parallelism, model parallelism)
    rank: int
    device: torch.device
    groups: dict  # axis name -> the process group of this rank's line along it

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def model_size(self) -> int:
        return self.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape[1]

    def size(self, axis: str | None) -> int:
        """Ranks along ``axis`` (None: all of them)."""
        return {DATA_AXIS: self.shape[0], MODEL_AXIS: self.shape[1],
                None: self.shape[0] * self.shape[1]}[axis]

    def index(self, axis: str | None) -> int:
        """This rank's index along ``axis`` (None: its global rank)."""
        return {DATA_AXIS: self.data_index, MODEL_AXIS: self.model_index, None: self.rank}[axis]

    def group(self, axis: str | None):
        return self.groups[axis]


def make_mesh(n_devices: int | None = None, model_parallelism: int = 1,
              device: torch.device | None = None) -> Mesh:
    """The (n / mp, mp) grid over the ranks of the initialized process
    group (``initialize_distributed``); every rank must call it, with the
    same arguments. ``n_devices`` defaults to, and must equal, the world
    size. ``device``: this rank's device (default: its card under NCCL,
    else the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_devices or world
    mp = model_parallelism
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}")
    if mp < 1 or n % mp:
        raise ValueError(f"model parallelism {mp} does not divide {n} ranks")
    grid = np.arange(n).reshape(n // mp, mp)
    groups = {None: dist.group.WORLD}
    # every rank creates every group, in the same order
    for axis, lines in ((DATA_AXIS, grid.T), (MODEL_AXIS, grid)):
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return Mesh((n // mp, mp), rank, device if device is not None else process_device(), groups)


# ------------------------------------------------------------- collectives
def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str | None, site: str) -> torch.Tensor:
    """Sum ``t`` in place over the ranks along ``axis`` (None: all ranks)."""
    with _count(site, _nbytes(t)):
        dist.all_reduce(t, group=mesh.group(axis))
    return t


def broadcast(t: torch.Tensor, mesh: Mesh, site: str, src: int = 0) -> torch.Tensor:
    """``t`` in place from global rank ``src`` to every rank."""
    with _count(site, _nbytes(t)):
        dist.broadcast(t, src=src, group=mesh.group(None))
    return t


def broadcast_object(obj, mesh: Mesh, site: str, src: int = 0):
    """A picklable host object from global rank ``src`` to every rank."""
    box = [obj]
    with _count(site, 0):
        dist.broadcast_object_list(box, src=src, group=mesh.group(None),
                                   device=mesh.device if mesh.device.type == "cuda" else None)
    return box[0]


def _gather(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    t = t.contiguous()
    if t.is_cuda:
        out = t.new_empty((n, *t.shape))
        dist.all_gather_into_tensor(out, t, group=group)
        parts = out.unbind(0)
    else:  # gloo gathers into a list
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _a2a(t: torch.Tensor, group, n: int, split_dim: int, cat_dim: int) -> torch.Tensor:
    send = torch.stack(t.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=cat_dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, site, dim):
        ctx.mesh, ctx.axis, ctx.site, ctx.dim = mesh, axis, site, dim
        with _count(site, _nbytes(t)):
            return _gather(t, mesh.group(axis), mesh.size(axis), dim)

    @staticmethod
    def backward(ctx, g):
        # the transpose of a gather: sum the ranks' gradients, keep this
        # rank's chunk (an all-reduce, which gloo has and reduce-scatter not)
        g = g.contiguous()
        with _count(ctx.site + ":bwd", _nbytes(g)):
            dist.all_reduce(g, group=ctx.mesh.group(ctx.axis))
        n, i = ctx.mesh.size(ctx.axis), ctx.mesh.index(ctx.axis)
        return g.chunk(n, dim=ctx.dim)[i], None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, site, split_dim, cat_dim):
        ctx.mesh, ctx.axis, ctx.site = mesh, axis, site
        ctx.split_dim, ctx.cat_dim = split_dim, cat_dim
        with _count(site, _nbytes(t)):
            return _a2a(t, mesh.group(axis), mesh.size(axis), split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        with _count(ctx.site + ":bwd", _nbytes(g)):
            out = _a2a(g, ctx.mesh.group(ctx.axis), ctx.mesh.size(ctx.axis), ctx.cat_dim,
                       ctx.split_dim)
        return out, None, None, None, None, None


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str | None, site: str,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` concatenated on ``dim``, in rank order."""
    return _AllGather.apply(t, mesh, axis, site, dim)


def all_to_all(t: torch.Tensor, mesh: Mesh, axis: str | None, site: str,
               split_dim: int = 0, cat_dim: int = 0) -> torch.Tensor:
    """``t`` split into n chunks on ``split_dim``, chunk j sent to the j-th
    rank along ``axis``; the chunks received concatenated on ``cat_dim``,
    in rank order."""
    return _AllToAll.apply(t, mesh, axis, site, split_dim, cat_dim)


# --------------------------------------------------------------- placement
def replicated(t: torch.Tensor, mesh: Mesh, site: str = "replicated") -> torch.Tensor:
    """``t`` made equal on every rank: rank 0's copy, broadcast (in place)."""
    return broadcast(t, mesh, site)


@dataclasses.dataclass(eq=False)
class RowSlice:
    """This rank's rows of a global batch of ``size`` rows: ``rows`` (L,)
    indexes them, padded to L = ceil(size / dp) by repeating the last one;
    ``real`` (L,) marks the unpadded ones; ``unshard`` (size,) picks the
    global order out of the ranks' gathered (dp * L) rows."""

    rows: torch.Tensor
    real: torch.Tensor
    unshard: torch.Tensor

    @property
    def length(self) -> int:
        return self.rows.shape[0]


_SLICES: dict = {}


def row_slice(size: int, mesh: Mesh, device=None) -> RowSlice:
    """The data axis's ``RowSlice`` of a ``size``-row batch (made once per
    size and device, so that a CUDA graph capture finds it made)."""
    dev = torch.device(device if device is not None else mesh.device)
    key = (size, mesh.data_size, mesh.data_index, dev)
    if key not in _SLICES:
        dp, L = mesh.data_size, -(-size // mesh.data_size)
        off, n = host_batch_slice(size, mesh.data_index, dp)
        rows = np.minimum(off + np.arange(L), max(off + n - 1, 0))
        unshard = np.concatenate([d * L + np.arange(host_batch_slice(size, d, dp)[1])
                                  for d in range(dp)])
        as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
        _SLICES[key] = RowSlice(as_t(rows, torch.long), as_t(np.arange(L) < n, torch.bool),
                                as_t(unshard, torch.long))
    return _SLICES[key]


def batch_sharded(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's rows of ``t`` along ``dim`` (``row_slice``; padded rows
    repeat the last real one)."""
    return t.index_select(dim, row_slice(t.shape[dim], mesh, t.device).rows)


def gather_rows(local: torch.Tensor, size: int, mesh: Mesh, site: str) -> torch.Tensor:
    """The ranks' ``batch_sharded`` rows of a ``size``-row batch, gathered
    over the data axis and put back in the global order (padding dropped)."""
    full = all_gather(local, mesh, DATA_AXIS, site)
    return full.index_select(0, row_slice(size, mesh, local.device).unshard)


def feature_sharded(table, mesh: Mesh, device=None) -> torch.Tensor:
    """This rank's block of a (rows, D) table's columns over the model
    axis: D padded with zero columns to a multiple of mp, then the
    model index's ceil(D / mp) columns."""
    t = torch.as_tensor(table)
    mp, w = mesh.model_size, -(-t.shape[1] // mesh.model_size)
    if w * mp != t.shape[1]:
        t = torch.cat([t, t.new_zeros((t.shape[0], w * mp - t.shape[1]))], dim=1)
    block = t[:, mesh.model_index * w:(mesh.model_index + 1) * w].contiguous()
    return block.to(device if device is not None else mesh.device)


class ColumnShardedTable:
    """A feature table of which this rank holds a block of columns
    (``feature_sharded``): indexing it gathers the rows' blocks over the
    model axis and drops the pad columns, so that a reader gets whole
    rows. The bytes moved are those of the rows read, never the table's."""

    def __init__(self, table, mesh: Mesh, site: str, device=None):
        self.mesh, self.site = mesh, site
        self.local = feature_sharded(table, mesh, device)
        self.shape = torch.Size((self.local.shape[0], torch.as_tensor(table).shape[1]))

    @property
    def device(self) -> torch.device:
        return self.local.device

    def __getitem__(self, idx) -> torch.Tensor:
        rows = self.local[idx]
        return all_gather(rows, self.mesh, MODEL_AXIS, self.site, dim=-1)[..., : self.shape[1]]
