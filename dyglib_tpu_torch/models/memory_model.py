"""Memory models: TGN, DyRep and JODIE over one framework.

Counterpart of ``dyglib_tpu/models/memory_model.py`` (f32 compute, the
``recent`` and ``uniform`` strategies). The memory bank is a value,
``MemoryState``, that the caller hands from step to step: per node its
memory, the time of its last update and ONE pending message slot (the
reference keeps only the last message of a node). Its rows are N + 1
rounded up to a multiple of 8; the last row is the dump row that padded
batch rows point at, and no write changes it.

  * The lazy memory view: a node with a pending message shows
    Cell(msg, memory), at the message's time; ``view_rows`` computes it for
    the gathered rows only (the cell is row-wise), ``memory_view`` over all
    nodes.
  * A message is [own memory || partner memory || Phi(t - own last update)
    || edge features] (2 * 172 + 100 + 172 = 616 wide at the published
    widths), computed from the COMMITTED memory; DyRep puts the partner's
    embedding in place of its memory.
  * ``commit`` (positive edges, gradient-free): commit the pending slots of
    the batch's nodes, then store each node's new message, keep-last per
    node, a destination-side message overwriting a source-side one. The
    writes go through the JAX package's last-occurrence mask, so each node
    has one writer (``index_put_`` with duplicate indices has no defined
    winner on CUDA); the other rows, padded ones included, write the dump
    row's own values back to it, so every writer of a row writes the same
    value, and no write waits on the host (no boolean indexing).
  * Cells: TGN a GRU cell, DyRep and JODIE an RNN cell (``nn/modules.py``).
  * Under a trainer's mesh the state is node-sharded over the data axis
    (``shard_state``): ``view_rows`` fetches the rows from their owners
    (``fetch_rows``) and ``commit`` routes messages to them
    (``_commit_sharded``); ``gather_state`` makes a checkpoint's whole
    state.
  * Embeddings: JODIE projects its view by time, mem * (1 + Linear(dt')),
    dt' the gap since the node's last update normalized by its ROLE's
    train-set statistics (``roles``, never inferred from the row count but
    for the quad layout); TGN and DyRep attend over K sampled neighbors as
    TGAT does, with layer-0 features memory view + raw node rows and each
    merge against the same. DyRep returns the updated memories in place of
    the attention's output; the attention's output only feeds its messages.

TGN's and DyRep's attention is ``TemporalMultiHeadAttention`` with
``use_pallas=True``: the fused temporal attention kernel
(``ops.temporal_attention``) and its backward kernel, whose gradients with
respect to the neighbor rows and the query reach the memory cell (the
JAX package takes XLA's path there: the same parameters and math). The
net's ``use_kernels`` (set from the adapter's at ``build``) is the one
switch: False calls the plain versions on any device, and CPU tensors
take them anyway. ``sample`` launches no kernel.

Time deltas follow the JAX package op for op: the attention's dt is taken
in int32 and then cast; the messages' and JODIE's dt cast both time keys
to f32 first.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import numpy as np
import torch
from torch import nn

from ..graph.csr import TemporalCSR
from ..graph.sampler import check_strategy, sample_multi_hop
from ..nn.modules import (
    FusedGRUCell,
    FusedRNNCell,
    MergeLayer,
    TemporalMultiHeadAttention,
    TimeEncoder,
    dropout,
    linear,
)
from ..parallel.mesh import DATA_AXIS, all_gather, all_to_all, row_slice
from .base import FeatureTables

MODEL_NAMES = ("TGN", "DyRep", "JODIE")


class MemoryState(NamedTuple):
    """The memory bank; every tensor has R = ceil((N + 1) / 8) * 8 rows."""

    memory: torch.Tensor  # (R, D) float32
    last_update: torch.Tensor  # (R,) int32 time keys
    msg: torch.Tensor  # (R, message_dim) float32, the keep-last slot
    msg_time: torch.Tensor  # (R,) int32
    msg_valid: torch.Tensor  # (R,) bool


class MemoryModelInputs(NamedTuple):
    ids4: torch.Tensor  # (M,) int32 query ids, e.g. the triple [src || dst || neg_dst]
    ts4: torch.Tensor  # (M,) int32 time keys
    hop_ids: tuple  # TGN/DyRep: per hop (B, K**h) int32 (level 0 = ids4); JODIE: (ids4,)
    hop_eids: tuple
    hop_ts: tuple
    hop_mask: tuple
    # per row: False = source role, True = destination role (JODIE's time
    # normalization is per role); None = the quad layout, allowed only when
    # the row count is a multiple of 4
    roles: torch.Tensor | None = None


class TimeShiftStats(NamedTuple):
    src_mean: float = 0.0
    src_std: float = 1.0
    dst_mean: float = 0.0
    dst_std: float = 1.0


def compute_src_dst_node_time_shifts(
    src: np.ndarray, dst: np.ndarray, ts: np.ndarray
) -> TimeShiftStats:
    """Mean and std of each role's gaps between a node's interactions, the
    first one measured from time 0. A stable argsort groups each node's
    interactions in stream order, so a gap is the difference of neighbors
    in the sorted times."""
    shifts = []
    for ids in (src, dst):
        order = np.argsort(ids, kind="stable")
        sorted_ts = ts[order].astype(np.float64)
        prev = np.empty(len(ids))
        prev[0] = 0.0
        prev[1:] = sorted_ts[:-1]
        sorted_ids = ids[order]
        first = np.empty(len(ids), dtype=bool)
        first[0] = True
        first[1:] = sorted_ids[1:] != sorted_ids[:-1]
        prev[first] = 0.0
        s = np.empty(len(ids))
        s[order] = sorted_ts - prev
        shifts.append(s)
    return TimeShiftStats(
        float(np.mean(shifts[0])), float(np.std(shifts[0])),
        float(np.mean(shifts[1])), float(np.std(shifts[1])),
    )


def segment_roles(b: int, layout: tuple[str, ...], device=None) -> torch.Tensor:
    """Role flags of B-row segments laid out as ``layout``, e.g. ("src",
    "dst", "dst") for the triple [src || dst || neg_dst]. True = destination."""
    for s in layout:
        if s not in ("src", "dst"):
            raise ValueError(f"unknown role {s!r}")
    # filled on the device (no host copy: a CUDA graph can capture it)
    return torch.cat([torch.full((b,), s == "dst", dtype=torch.bool, device=device)
                      for s in layout])


def quad_roles(b: int, device=None) -> torch.Tensor:
    """Roles of the quad layout [src || dst || neg_src || neg_dst]."""
    return segment_roles(b, ("src", "dst", "src", "dst"), device)


class MemoryModelNet(nn.Module):
    """The parameters and the differentiable compute of one memory model."""

    def __init__(
        self,
        model_name: str,
        node_dim: int,
        edge_dim: int,
        gen: torch.Generator,
        memory_dim: int = 172,
        time_feat_dim: int = 100,
        num_layers: int = 1,
        num_heads: int = 2,
        dropout: float = 0.1,
        time_shifts: TimeShiftStats = TimeShiftStats(),
        use_kernels: bool = True,
    ):
        super().__init__()
        if model_name not in MODEL_NAMES:
            raise ValueError(f"unknown memory model {model_name!r}")
        self.model_name = model_name
        self.num_layers = num_layers
        self.dropout = dropout
        self.time_shifts = time_shifts
        self.use_kernels = use_kernels
        # set by a trainer under a mesh: the state is then this rank's
        # shard of the node rows (``shard_state``)
        self.mesh = None
        self.time_encoder = TimeEncoder(time_feat_dim)
        message_dim = 2 * memory_dim + time_feat_dim + edge_dim
        cell = FusedGRUCell if model_name == "TGN" else FusedRNNCell
        self.memory_cell = cell(message_dim, memory_dim, gen)
        if model_name == "JODIE":
            self.time_projection = linear(1, memory_dim, gen)
            return
        if memory_dim != node_dim:
            raise ValueError(
                f"{model_name}'s layer-0 features are memory + node rows: memory_dim "
                f"{memory_dim} must equal the node feature width {node_dim}"
            )
        for l in range(num_layers):
            self.add_module(
                f"temporal_conv_{l}",
                TemporalMultiHeadAttention(
                    memory_dim, edge_dim, time_feat_dim, num_heads, dropout, gen,
                    use_pallas=True,
                ),
            )
            self.add_module(
                f"merge_{l}",
                MergeLayer(memory_dim + time_feat_dim + memory_dim, memory_dim, memory_dim, gen),
            )

    def memory_view(self, state: MemoryState) -> tuple[torch.Tensor, torch.Tensor]:
        """The lazily updated (memory, last_update) of every row."""
        upd = self.memory_cell(state.memory, state.msg)
        memory = torch.where(state.msg_valid[:, None], upd, state.memory)
        return memory, torch.where(state.msg_valid, state.msg_time, state.last_update)

    def view_rows(self, state: MemoryState, rows: torch.Tensor):
        """``memory_view(state)`` at ``rows`` only: (memory, last_update).
        Under a mesh ``rows`` are global ids, read from their owners
        (``fetch_rows``); the cell runs here, so gradients stay local."""
        rows = rows.long()
        if self.mesh is not None:
            mem, msg, lu, msg_time, valid = fetch_rows(state, rows, self.mesh)
        else:
            mem, msg, lu = state.memory[rows], state.msg[rows], state.last_update[rows]
            msg_time, valid = state.msg_time[rows], state.msg_valid[rows]
        upd = self.memory_cell(mem, msg)
        memory = torch.where(valid[:, None], upd, mem)
        return memory, torch.where(valid, msg_time, lu)

    def forward(
        self,
        tables: FeatureTables,
        state: MemoryState,
        inputs: MemoryModelInputs,
        *,
        dropout_gen: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Embeddings (M, D) of ``inputs.ids4`` against the lazy view of
        ``state`` (no commit). In train mode with dropout > 0,
        ``dropout_gen`` (on the inputs' device) draws the masks."""
        if self.model_name == "JODIE":
            mem_rows, lu_rows = self.view_rows(state, inputs.ids4)
            dt = inputs.ts4.to(torch.float32) - lu_rows.to(torch.float32)
            roles = inputs.roles
            if roles is None:
                m = inputs.ids4.shape[0]
                if m % 4:
                    raise ValueError(
                        f"JODIE needs explicit inputs.roles for a layout of {m} rows")
                roles = quad_roles(m // 4, dt.device)
            s = self.time_shifts
            mean = torch.where(roles, s.dst_mean, s.src_mean).to(torch.float32)
            std = torch.where(roles, s.dst_std, s.src_std).to(torch.float32)
            proj = self.time_projection(((dt - mean) / std)[:, None])
            p = self.dropout if self.training else 0.0
            return dropout(mem_rows * (1.0 + proj), p, dropout_gen)

        L = self.num_layers
        flat_ids = [ids.reshape(-1).long() for ids in inputs.hop_ids]
        flat_ts = [ts.reshape(-1) for ts in inputs.hop_ts]
        base = [self.view_rows(state, ids)[0] + tables.node[ids] for ids in flat_ids]
        feats = list(base)
        kw = dict(use_kernels=self.use_kernels, dropout_gen=dropout_gen)
        for l in range(1, L + 1):
            conv = getattr(self, f"temporal_conv_{l - 1}")
            merge = getattr(self, f"merge_{l - 1}")
            new_feats = []
            for h in range(0, L - l + 1):
                m = flat_ids[h].shape[0]
                kk = flat_ids[h + 1].shape[0] // m
                # exact int32 delta, then f32
                dt = (flat_ts[h][:, None] - flat_ts[h + 1].reshape(m, kk)).to(torch.float32)
                zeros = torch.zeros((m, 1), dtype=torch.float32, device=dt.device)
                phi_0 = self.time_encoder(zeros)[:, 0, :]
                edge_feat = tables.edge[inputs.hop_eids[h].reshape(m, kk).long()]
                mask = inputs.hop_mask[h].reshape(m, kk)
                out, _ = conv(feats[h], phi_0, feats[h + 1].reshape(m, kk, -1),
                              self.time_encoder(dt), edge_feat, mask, **kw)
                new_feats.append(merge(out, base[h]))
            feats = new_feats
        return feats[0].reshape(inputs.ids4.shape[0], -1)

    def new_messages(
        self,
        tables: FeatureTables,
        memory: torch.Tensor,
        last_update: torch.Tensor,
        own_ids: torch.Tensor,
        partner_ids: torch.Tensor,
        partner_emb: torch.Tensor,
        ts: torch.Tensor,
        eids: torch.Tensor,
    ) -> torch.Tensor:
        """Messages for ``own_ids`` from the committed memory."""
        own = own_ids.long()
        return self.message(tables, memory[own], last_update[own], memory[partner_ids.long()],
                            partner_emb, ts, eids)

    def message(self, tables, own_mem, own_lu, partner_mem, partner_emb, ts, eids):
        """[own memory || partner memory (DyRep: its embedding) ||
        Phi(t - own last update) || edge features] of rows already read."""
        if self.model_name == "DyRep":
            partner_mem = partner_emb
        dt = ts.to(torch.float32) - own_lu.to(torch.float32)
        return torch.cat([own_mem, partner_mem, self.time_encoder(dt), tables.edge[eids.long()]],
                         dim=-1)


def memory_order_violations(
    prev_last_update: np.ndarray, prev_msg_time: np.ndarray, new_state: MemoryState
) -> int:
    """How many node clocks moved backwards across a state transition.

    In a chronological stream ``last_update`` only advances to committed
    message times, and a message slot only takes times at or after the one
    it overwrites (clearing a slot leaves its time), so a nonzero count
    means batches were applied out of order or the state was corrupted.
    The dump row (the last) is left out."""
    lu = new_state.last_update.cpu().numpy()[:-1]
    mt = new_state.msg_time.cpu().numpy()[:-1]
    return int(
        np.sum(lu < np.asarray(prev_last_update)[:-1]) + np.sum(mt < np.asarray(prev_msg_time)[:-1])
    )


def _last_occurrence_mask(safe_ids: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    """True at the LAST valid position of each id: one writer per node."""
    pos = torch.arange(safe_ids.shape[0], device=safe_ids.device)
    pos_v = torch.where(valid, pos, -1)
    seg_last = torch.full((n + 1,), -1, dtype=pos.dtype, device=pos.device)
    seg_last = seg_last.scatter_reduce(0, safe_ids, pos_v, reduce="amax")
    return valid & (seg_last[safe_ids] == pos_v)


# ------------------------------------------------- node-sharded state (mesh)
# Each data rank owns a contiguous block of S = ceil(R / dp) of the R global
# rows (rank d: rows [d S, (d + 1) S)) plus one dump row of its own, local
# row S, which the writes of rows it does not own go to. No collective
# carries a tensor that grows with the number of nodes: a read sends the
# ids it needs and gets those rows back, a commit routes each kept row's
# message to its owner. Only ``gather_state`` (a checkpoint) moves a shard.

def state_rows(num_nodes: int) -> int:
    """R, the rows of an unsharded state: num_nodes + 1 rounded up to 8."""
    return ((num_nodes + 1 + 7) // 8) * 8


def shard_rows(rows: int, mesh) -> int:
    """S, the global rows a data rank owns."""
    return -(-rows // mesh.data_size)


def shard_state(state: MemoryState, mesh) -> MemoryState:
    """A whole state (R rows, the last its dump row) -> this data rank's
    shard: its S rows and a dump row (the whole state's, all zero)."""
    r = state.memory.shape[0]
    s = shard_rows(r, mesh)
    lo = mesh.index(DATA_AXIS) * s

    def part(t):
        pad = t.new_zeros((mesh.data_size * s - r + 1, *t.shape[1:]))
        full = torch.cat([t, pad])  # row dp*s is a zero dump row
        return torch.cat([full[lo:lo + s], full[-1:]])

    return MemoryState(*(part(t) for t in state))


def gather_state(state: MemoryState, mesh, rows: int) -> MemoryState:
    """The shards of the data axis gathered into the whole R-row state (every
    rank gets it; a checkpoint's only num_nodes-sized collective)."""
    s = state.memory.shape[0] - 1

    def whole(t, name):
        if t.dtype == torch.bool:
            return whole(t.to(torch.int32), name).to(torch.bool)
        return all_gather(t[:s].contiguous(), mesh, DATA_AXIS, f"checkpoint/{name}")[:rows]

    return MemoryState(*(whole(t, name) for t, name in zip(state, MemoryState._fields)))


def _as_f32(t: torch.Tensor) -> torch.Tensor:
    """int32 / bool columns carried bit for bit in a float32 payload."""
    return t.to(torch.int32).view(torch.float32)


def _owners(ids: torch.Tensor, s: int, mesh):
    """(dp, n) local rows each data rank is asked for: the id's local row on
    its owner, the dump row s on every other rank."""
    ranks = torch.arange(mesh.data_size, device=ids.device)[:, None]
    return torch.where(ids[None, :] // s == ranks, ids[None, :] % s, s)


def fetch_rows(state: MemoryState, ids: torch.Tensor, mesh):
    """(memory, msg, last_update, msg_time, msg_valid) at global ``ids`` from
    their owners, by two all-to-alls over the data axis: the ids out, the
    rows back (one float32 payload a row, the clocks and flag bitwise)."""
    s = state.memory.shape[0] - 1
    n = ids.shape[0]
    asked = all_to_all(_owners(ids, s, mesh).to(torch.int32), mesh, DATA_AXIS,
                       "memory/ids").reshape(-1).long()
    payload = torch.cat([state.memory[asked], state.msg[asked],
                         _as_f32(state.last_update[asked])[:, None],
                         _as_f32(state.msg_time[asked])[:, None],
                         _as_f32(state.msg_valid[asked])[:, None]], dim=1)
    back = all_to_all(payload.reshape(mesh.data_size, n, -1), mesh, DATA_AXIS, "memory/rows")
    got = back[ids // s, torch.arange(n, device=ids.device)]  # the owner's answer
    d, w = state.memory.shape[1], state.msg.shape[1]
    ints = got[:, d + w:].contiguous().view(torch.int32)
    # contiguous, as a gather's rows are: the cell's products then round
    # as they do on one device
    return (got[:, :d].contiguous(), got[:, d:d + w].contiguous(), ints[:, 0], ints[:, 1],
            ints[:, 2].to(torch.bool))


@dataclasses.dataclass
class MemoryModel:
    """Backbone adapter for TGN, DyRep and JODIE: sampling, the net's
    construction, the memory's initial state, the commit and the embedding
    of a batch. Where the JAX adapter takes ``params``, this one takes the
    built net."""

    model_name: str = "TGN"
    memory_dim: int = 172
    num_neighbors: int = 10
    num_layers: int = 1
    num_heads: int = 2
    dropout: float = 0.1
    time_feat_dim: int = 100
    sample_strategy: str = "recent"
    time_shifts: TimeShiftStats = TimeShiftStats()
    # the built net's initial setting; the net's own ``use_kernels`` is
    # the switch from then on
    use_kernels: bool = True
    # the trainer threads a MemoryState through the batches
    has_state: ClassVar[bool] = True
    # embeddings depend only on (node, time) given the shared memory view:
    # the trainer embeds the triple [src, dst, neg_dst] and reuses src's
    # rows for neg_src
    pair_independent: ClassVar[bool] = True

    def __post_init__(self):
        if self.model_name not in MODEL_NAMES:
            raise ValueError(f"unknown memory model {self.model_name!r}")
        check_strategy(self.sample_strategy)

    def build(self, node_dim: int, edge_dim: int, gen: torch.Generator) -> MemoryModelNet:
        """A MemoryModelNet whose parameters are drawn from ``gen`` (on the CPU)."""
        return MemoryModelNet(
            self.model_name, node_dim, edge_dim, gen,
            memory_dim=self.memory_dim,
            time_feat_dim=self.time_feat_dim,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            dropout=self.dropout,
            time_shifts=self.time_shifts,
            use_kernels=self.use_kernels,
        )

    def sample(
        self, csr: TemporalCSR, ids: torch.Tensor, ts: torch.Tensor,
        gen: torch.Generator | None = None,
    ) -> MemoryModelInputs:
        """The hop tensors of queries (ids, ts); JODIE samples nothing.
        ``uniform`` draws from ``gen`` (on the CSR's device)."""
        ids, ts = ids.to(torch.int32), ts.to(torch.int32)
        if self.model_name == "JODIE":
            return MemoryModelInputs(ids, ts, (ids,), (), (ts,), ())
        blocks = sample_multi_hop(
            csr, ids, ts, self.num_neighbors, self.num_layers, self.sample_strategy, gen=gen
        )
        b = ids.shape[0]
        return MemoryModelInputs(
            ids4=ids,
            ts4=ts,
            hop_ids=(ids,) + tuple(blk.nbr.reshape(b, -1) for blk in blocks),
            hop_eids=tuple(blk.eid.reshape(b, -1) for blk in blocks),
            hop_ts=(ts,) + tuple(blk.ts.reshape(b, -1) for blk in blocks),
            hop_mask=tuple(blk.mask.reshape(b, -1) for blk in blocks),
        )

    def init_state(self, tables: FeatureTables, mesh=None) -> MemoryState:
        """An empty memory on the tables' device (under a mesh, this data
        rank's shard: S + 1 rows)."""
        rows = state_rows(tables.node.shape[0])
        if mesh is not None:
            rows = shard_rows(rows, mesh) + 1
        message_dim = 2 * self.memory_dim + self.time_feat_dim + tables.edge_dim
        zeros = lambda *shape, dtype=torch.float32: torch.zeros(
            shape, dtype=dtype, device=tables.node.device)
        return MemoryState(
            memory=zeros(rows, self.memory_dim),
            last_update=zeros(rows, dtype=torch.int32),
            msg=zeros(rows, message_dim),
            msg_time=zeros(rows, dtype=torch.int32),
            msg_valid=zeros(rows, dtype=torch.bool),
        )

    @torch.no_grad()
    def commit(
        self,
        net: MemoryModelNet,
        tables: FeatureTables,
        state: MemoryState,
        src: torch.Tensor,
        dst: torch.Tensor,
        ts: torch.Tensor,
        eids: torch.Tensor,
        valid: torch.Tensor,
        src_emb: torch.Tensor,
        dst_emb: torch.Tensor,
    ) -> MemoryState:
        """The positive edges' state transition -> a new MemoryState (the
        input is not modified): commit the pending messages of src and dst,
        clear their slots, then store new messages computed from the
        committed memory. No gradient flows through it (the reference
        detaches the memory at every batch boundary); ``src_emb`` and
        ``dst_emb`` are the raw embeddings DyRep's messages carry. Under a
        mesh (``net.mesh``) the batch columns are the GLOBAL batch, the
        embeddings this rank's rows of it, and the state a shard
        (``_commit_sharded``)."""
        if net.mesh is not None:
            return self._commit_sharded(net, tables, state, src, dst, ts, eids, valid,
                                        src_emb, dst_emb)
        n = state.memory.shape[0] - 1
        valid = valid.to(torch.bool)
        ids2 = torch.cat([src, dst]).long()
        valid2 = torch.cat([valid, valid])
        safe2 = torch.where(valid2, ids2, n)
        # commit the pending slots: a node seen twice commits once, and every
        # other row writes the dump row's own values back to it
        keep2 = _last_occurrence_mask(safe2, valid2, n)
        rows = torch.where(keep2, safe2, n)
        pending = (state.msg_valid[rows] & keep2)[:, None]
        upd = net.memory_cell(state.memory[rows], state.msg[rows])
        memory, last_update = state.memory.clone(), state.last_update.clone()
        msg_valid = state.msg_valid.clone()
        memory[rows] = torch.where(pending, upd, state.memory[rows])
        last_update[rows] = torch.where(pending[:, 0], state.msg_time[rows],
                                        state.last_update[rows])
        msg_valid[rows] = state.msg_valid[rows] & ~keep2
        # new messages, keep-last per node; the destination side's
        # overwrite the source side's for nodes in both
        msg, msg_time = state.msg.clone(), state.msg_time.clone()
        ts = ts.to(torch.int32)
        for own, partner, partner_emb in ((src, dst, dst_emb), (dst, src, src_emb)):
            own_safe = torch.where(valid, own.long(), n)
            keep = _last_occurrence_mask(own_safe, valid, n)
            idx = torch.where(keep, own_safe, n)
            new = net.new_messages(tables, memory, last_update, own_safe,
                                   torch.where(valid, partner.long(), n), partner_emb, ts, eids)
            msg[idx] = torch.where(keep[:, None], new, msg[idx])
            msg_time[idx] = torch.where(keep, ts, msg_time[idx])
            msg_valid[idx] = keep | msg_valid[idx]
        return MemoryState(memory, last_update, msg, msg_time, msg_valid)

    def _commit_sharded(self, net, tables, state, src, dst, ts, eids, valid, src_emb, dst_emb):
        """``commit`` on a node-sharded state. Every rank computes the global
        last-occurrence masks from the global batch; each owner commits the
        pending slots of the kept rows it owns; each rank reads the committed
        rows of its own batch rows' nodes from their owners, computes their
        messages and routes each kept one to its owner, which stores the
        source side's, then the destination side's (which win for a node
        on both)."""
        mesh = net.mesh
        s = state.memory.shape[0] - 1
        n = s * mesh.data_size  # the global id of no row: the masks' dump
        d = mesh.index(DATA_AXIS)
        valid = valid.to(torch.bool)
        ids2 = torch.cat([src, dst]).long()
        valid2 = torch.cat([valid, valid])
        safe2 = torch.where(valid2, ids2, n)
        keep2 = _last_occurrence_mask(safe2, valid2, n) & (safe2 // s == d)
        rows = torch.where(keep2, safe2 % s, s)
        pending = (state.msg_valid[rows] & keep2)[:, None]
        upd = net.memory_cell(state.memory[rows], state.msg[rows])
        memory, last_update = state.memory.clone(), state.last_update.clone()
        msg_valid = state.msg_valid.clone()
        memory[rows] = torch.where(pending, upd, state.memory[rows])
        last_update[rows] = torch.where(pending[:, 0], state.msg_time[rows],
                                        state.last_update[rows])
        msg_valid[rows] = state.msg_valid[rows] & ~keep2

        sl = row_slice(src.shape[0], mesh, src.device)
        loc = lambda t: t.index_select(0, sl.rows)
        ts = ts.to(torch.int32)
        l_src, l_dst, l_ts, l_eid = loc(src).long(), loc(dst).long(), loc(ts), loc(eids)
        # the committed rows of this rank's batch nodes, from their owners
        committed = MemoryState(memory, last_update, state.msg, state.msg_time, msg_valid)
        mem, _, lu, _, _ = fetch_rows(committed, torch.cat([l_src, l_dst]), mesh)
        b = l_src.shape[0]
        sides = []
        for own, (om, ol), pm, pe in (
            (src, (mem[:b], lu[:b]), mem[b:], dst_emb),
            (dst, (mem[b:], lu[b:]), mem[:b], src_emb),
        ):
            own_safe = torch.where(valid, own.long(), n)
            kept = loc(_last_occurrence_mask(own_safe, valid, n)) & sl.real
            target = loc(own_safe)
            new = net.message(tables, om, ol, pm, pe, l_ts, l_eid)
            # (dp, b) local row on each rank: the owner's row if kept, else its dump
            dest = torch.where(kept[None, :], _owners(target, s, mesh), s)
            sides.append(torch.cat([new.expand(mesh.data_size, -1, -1),
                                    _as_f32(l_ts).expand(mesh.data_size, -1)[..., None],
                                    _as_f32(dest)[..., None]], dim=-1))
        got = all_to_all(torch.stack(sides, 1), mesh, DATA_AXIS, "memory/messages")
        msg, msg_time = state.msg.clone(), state.msg_time.clone()
        w = msg.shape[1]
        for side in got.unbind(1):  # (dp, b, w + 2): the source side first
            side = side.reshape(-1, w + 2)
            ints = side[:, w:].contiguous().view(torch.int32)
            idx, keep = ints[:, 1].long(), ints[:, 1] < s
            msg[idx] = torch.where(keep[:, None], side[:, :w], msg[idx])
            msg_time[idx] = torch.where(keep, ints[:, 0], msg_time[idx])
            msg_valid[idx] = keep | msg_valid[idx]
        return MemoryState(memory, last_update, msg, msg_time, msg_valid)

    def embed_quad(
        self,
        net: MemoryModelNet,
        tables: FeatureTables,
        state: MemoryState,
        inputs: MemoryModelInputs,
        dropout_gen: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(output embeddings, raw embeddings) of ``inputs.ids4``. The raw
        ones are the net's outputs, what ``commit`` takes as partner
        embeddings; DyRep's outputs are the updated memories."""
        raw = net(tables, state, inputs, dropout_gen=dropout_gen)
        if self.model_name == "DyRep":
            return net.view_rows(state, inputs.ids4)[0], raw
        return raw, raw

    def forward_and_maybe_commit(
        self,
        net: MemoryModelNet,
        tables: FeatureTables,
        state: MemoryState,
        inputs: MemoryModelInputs,
        src, dst, ts, eids, valid,
        *,
        edges_are_positive: bool = True,
        dropout_gen: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, MemoryState]:
        """One step: the output embeddings of ``inputs``, and the state after
        committing the positive edges (src, dst), whose rows lead ids4.
        Training runs ``embed_quad`` inside the loss and ``commit`` outside
        autograd instead (``LinkPredictionTrainer.train_step``)."""
        embs, raw = self.embed_quad(net, tables, state, inputs, dropout_gen)
        if not edges_are_positive:
            return embs, state
        b = src.shape[0]
        return embs, self.commit(net, tables, state, src, dst, ts, eids, valid,
                                 raw[:b], raw[b : 2 * b])
