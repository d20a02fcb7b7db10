"""Device-resident temporal adjacency in CSR form.

Counterpart of ``dyglib_tpu/graph/csr.py`` (``offsets/nbr/eid/ts``, the
next-hop window bounds ``nbr_hi``, the entry-ordered feature table
``feat_entry``, GraphMixer's per-segment feature prefix sums
``feat_prefix`` and CAWN's time-interval-aware cumulative weights
``tia_cew``; the TPU layout aid ``pack`` and the 128-lane slab transpose
of ``feat_entry`` are not ported). The undirected temporal graph is
stored as three flat arrays plus ``offsets``; each node's segment is
sorted by time, ties broken by edge order with an edge's src-side entry
first.

The host builds it: the native builder (``native/``, a counting sort in
C++, compiled at first use) where a compiler is present, else numpy's
interleave + stable argsort, which give the same arrays; the arrays then
live on the device. Times are int32 keys, so strictly-before visibility and time
deltas are exact for every integer-timestamped dataset.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..data.containers import EdgeStream
from ..native import build_temporal_csr_native


@dataclasses.dataclass
class TemporalCSR:
    """Time-sorted undirected CSR adjacency (tensors on one device)."""

    offsets: torch.Tensor  # (N+1,) int32 — segment boundaries per node id
    nbr: torch.Tensor  # (M,) int32 — neighbor node ids
    eid: torch.Tensor  # (M,) int32 — edge ids
    ts: torch.Tensor  # (M,) int32 — interaction time keys (sorted per segment)
    # (M,) int32 — for entry e = (u -> v at time t): the left insertion
    # point of t in v's segment, so the strictly-before window of the
    # next-hop query (v, t) is [offsets[v], nbr_hi[e]): one gather in place
    # of a bisection per multi-hop query (graph/sampler.py)
    nbr_hi: torch.Tensor
    # unroll count of per-segment binary searches: ceil(log2(max degree)) + 1
    segment_bisect_steps: int
    # (pad + M + pad + node_rows, Dn + De) f32 or None — per-entry
    # [node_feat[nbr[i]] || edge_feat[eid[i]]] rows in flat CSR order, with
    # zero guard rows on each side and a trailing per-node
    # [node_feat[n] || 0] block, so that a DyGFormer sequence (target row,
    # then its contiguous recent window) is one contiguous fetch
    # (ops/window_fetch.py). Packed row-major: 344 floats (1376 B, a
    # multiple of 16 B) at the published widths.
    feat_entry: torch.Tensor | None = None
    feat_entry_node_dim: int = 0
    # zero guard rows on each side of feat_entry's entry block (layout
    # [guard | entries | guard | node rows])
    feat_entry_guard_pad: int = 0
    # (M, Dn) f32 or None — inclusive per-segment prefix sums of the peer
    # nodes' features: a recent window's feature sum is two row reads
    # (GraphMixer's node encoder)
    feat_prefix: torch.Tensor | None = None
    # (M,) f32 or None — per-segment cumulative sums of exp(CAWN's
    # time-interval-aware logits), searched by time_interval_aware sampling
    tia_cew: torch.Tensor | None = None

    @property
    def num_entries(self) -> int:
        return self.nbr.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.offsets.shape[0] - 1


def time_keys(ts: np.ndarray) -> np.ndarray:
    """Integer time keys for exact device-side comparisons (ceil of
    non-integer times, which preserves strictly-before for integer event
    times)."""
    keys = np.ceil(np.asarray(ts, dtype=np.float64))
    if keys.size and keys.max() >= 2**31:
        raise ValueError("timestamps exceed int32 range")
    return keys.astype(np.int64)


# the fewest zero guard rows on each side of feat_entry
FEAT_ENTRY_PAD = 512


def _node_block_rows(num_nodes: int) -> int:
    """Rows of feat_entry's per-node block: num_nodes rounded up to 8, plus
    8 (the JAX package's layout, kept so that the tables compare)."""
    return -(-num_nodes // 8) * 8 + 8


def _segment_steps(offsets: np.ndarray) -> int:
    max_deg = int(np.max(np.diff(offsets))) if len(offsets) > 1 else 1
    return max(1, int(math.ceil(math.log2(max(max_deg, 2)))) + 1)


def _entries_numpy(stream: EdgeStream, num_nodes: int):
    """(offsets, peer, eid, ts) of the CSR's entries: the interleave (an
    edge's src-side entry, then its dst-side one) and a stable argsort by node."""
    e = stream.num_interactions
    node = np.empty(2 * e, dtype=np.int64)
    peer = np.empty(2 * e, dtype=np.int64)
    eid = np.empty(2 * e, dtype=np.int64)
    ts = np.empty(2 * e, dtype=np.float64)
    # interleave so per-edge append order (src entry, then dst entry) survives
    node[0::2], node[1::2] = stream.src, stream.dst
    peer[0::2], peer[1::2] = stream.dst, stream.src
    eid[0::2] = eid[1::2] = stream.eid
    ts[0::2] = ts[1::2] = stream.ts
    order = np.argsort(node, kind="stable")  # chronological per node
    offsets = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(node, minlength=num_nodes), out=offsets[1:])
    return offsets, peer[order], eid[order], ts[order]


def build_temporal_csr(
    stream: EdgeStream,
    num_nodes: int | None = None,
    device: str | torch.device = "cpu",
    feat_entry_of: tuple[np.ndarray, np.ndarray] | None = None,
    feat_entry_pad: int = FEAT_ENTRY_PAD,
    feat_prefix_of: np.ndarray | None = None,
    with_tia: bool = False,
    time_scaling_factor: float = 0.0,
) -> TemporalCSR:
    """Host-side CSR construction from a chronological edge stream.

    ``feat_entry_of = (node_feat, edge_feat)`` also builds ``feat_entry``
    with max(feat_entry_pad, 512) guard rows on each side. Row 0 of both
    tables must be zero: the fetch writes zeros where the gather path reads
    node row 0 and edge row 0, and the two agree only then.
    ``feat_prefix_of = node_feat`` builds ``feat_prefix``; ``with_tia``
    builds ``tia_cew`` with the logits' ``time_scaling_factor``.
    """
    if num_nodes is None:
        num_nodes = int(max(stream.src.max(), stream.dst.max())) + 1
    # the native builder (one counting-sort pass) where a host compiler is
    # present; else the interleave + stable argsort, the same arrays
    native = build_temporal_csr_native(stream.src, stream.dst, stream.eid, stream.ts, num_nodes)
    if native is not None:
        offsets, peer, eid, ts = native
        peer, eid = peer.astype(np.int64), eid.astype(np.int64)
    else:
        offsets, peer, eid, ts = _entries_numpy(stream, num_nodes)
    keys = time_keys(ts)
    # the flat arrays are sorted by (node, time key), so one global
    # searchsorted of every entry's (peer, time key) gives offsets[peer]
    # plus the left insertion point in the peer's segment
    seg_node = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(offsets))
    nbr_hi = np.searchsorted((seg_node << 32) | keys, (peer << 32) | keys, side="left")

    as_i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
    feat_entry, node_dim, pad = None, 0, 0
    if feat_entry_of is not None:
        node_f, edge_f = feat_entry_of
        if np.any(node_f[0] != 0) or np.any(edge_f[0] != 0):
            raise ValueError("feat_entry needs row 0 of the node and edge tables to be zero")
        m, node_dim, de = len(peer), node_f.shape[1], edge_f.shape[1]
        pad = max(int(feat_entry_pad), FEAT_ENTRY_PAD)
        table = np.zeros((2 * pad + m + _node_block_rows(num_nodes), node_dim + de), np.float32)
        table[pad : pad + m, :node_dim] = node_f[peer]
        table[pad : pad + m, node_dim:] = edge_f[eid]
        table[2 * pad + m : 2 * pad + m + num_nodes, :node_dim] = node_f[:num_nodes]
        feat_entry = torch.from_numpy(table).to(device)
    as_f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
    feat_prefix = tia_cew = None
    if feat_prefix_of is not None:
        feat_prefix = as_f32(segment_feature_prefix(offsets, peer, feat_prefix_of))
    if with_tia:
        tia_cew = as_f32(tia_cumulative_weights(offsets, ts, time_scaling_factor))
    return TemporalCSR(
        offsets=as_i32(offsets),
        nbr=as_i32(peer),
        eid=as_i32(eid),
        ts=as_i32(keys),
        nbr_hi=as_i32(nbr_hi),
        segment_bisect_steps=_segment_steps(offsets),
        feat_entry=feat_entry,
        feat_entry_node_dim=node_dim,
        feat_entry_guard_pad=pad,
        feat_prefix=feat_prefix,
        tia_cew=tia_cew,
    )


def segment_feature_prefix(
    offsets: np.ndarray, peer: np.ndarray, node_features: np.ndarray
) -> np.ndarray:
    """(M, D) inclusive per-segment prefix sums of the peer nodes' features,
    accumulated in float64 and stored float32 (``_segment_feature_prefix``
    of the JAX package): a window's sum feat_prefix[hi-1] -
    feat_prefix[lo-1] then carries one f32 rounding per entry, ~1e-6 of the
    direct gather's sum."""
    feats = np.asarray(node_features, dtype=np.float64)[peer]
    cs = np.cumsum(feats, axis=0)
    seg_id = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    start = np.asarray(offsets)[seg_id]  # each entry's segment start
    base = np.where((start > 0)[:, None], cs[np.maximum(start, 1) - 1], 0.0)
    return (cs - base).astype(np.float32)


def tia_cumulative_weights(offsets: np.ndarray, ts: np.ndarray, alpha: float) -> np.ndarray:
    """(M,) per-segment cumulative sums of exp(v_i), v_i CAWN's logits
    exp(alpha dt_i) / sum_{j<=i} exp(alpha dt_j), dt relative to the node's
    last interaction; a 0/0 position gets -1e10, whose exp is 0
    (``_tia_cumulative_weights`` of the JAX package). ``ts`` are the
    entries' raw times in CSR order."""
    if len(ts) == 0:
        return np.zeros(0, dtype=np.float32)
    seg_id = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))

    def seg_cumsum(x: np.ndarray) -> np.ndarray:
        cs = np.cumsum(x)
        start = offsets[seg_id]
        return cs - (cs[start] - x[start])

    ew = np.exp(alpha * (ts - ts[offsets[seg_id + 1] - 1]))
    wcs = seg_cumsum(ew)
    with np.errstate(invalid="ignore", divide="ignore"):
        v = np.where(wcs > 0, ew / wcs, -1e10)
    return seg_cumsum(np.exp(v)).astype(np.float32)
