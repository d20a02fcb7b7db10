"""Device-resident temporal adjacency in CSR form.

Counterpart of ``dyglib_tpu/graph/csr.py`` (``offsets/nbr/eid/ts`` only:
the TPU layout aids ``pack``, ``feat_entry`` and the CAWN/GraphMixer
tables come with their slices). The undirected temporal graph is stored
as three flat arrays plus ``offsets``; each node's segment is sorted by
time, ties broken by edge order with an edge's src-side entry first.

Host numpy builds it (the interleave + stable argsort, whose output the
JAX package's native builder reproduces exactly); the arrays then live on
the device. Times are int32 keys, so strictly-before visibility and time
deltas are exact for every integer-timestamped dataset.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..data.containers import EdgeStream


@dataclasses.dataclass
class TemporalCSR:
    """Time-sorted undirected CSR adjacency (tensors on one device)."""

    offsets: torch.Tensor  # (N+1,) int32 — segment boundaries per node id
    nbr: torch.Tensor  # (M,) int32 — neighbor node ids
    eid: torch.Tensor  # (M,) int32 — edge ids
    ts: torch.Tensor  # (M,) int32 — interaction time keys (sorted per segment)
    # unroll count of per-segment binary searches: ceil(log2(max degree)) + 1
    segment_bisect_steps: int

    @property
    def num_entries(self) -> int:
        return self.nbr.shape[0]


def time_keys(ts: np.ndarray) -> np.ndarray:
    """Integer time keys for exact device-side comparisons (ceil of
    non-integer times, which preserves strictly-before for integer event
    times)."""
    keys = np.ceil(np.asarray(ts, dtype=np.float64))
    if keys.size and keys.max() >= 2**31:
        raise ValueError("timestamps exceed int32 range")
    return keys.astype(np.int64)


def _segment_steps(offsets: np.ndarray) -> int:
    max_deg = int(np.max(np.diff(offsets))) if len(offsets) > 1 else 1
    return max(1, int(math.ceil(math.log2(max(max_deg, 2)))) + 1)


def build_temporal_csr(
    stream: EdgeStream,
    num_nodes: int | None = None,
    device: str | torch.device = "cpu",
) -> TemporalCSR:
    """Host-side CSR construction from a chronological edge stream."""
    if num_nodes is None:
        num_nodes = int(max(stream.src.max(), stream.dst.max())) + 1
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
    peer, eid, ts = peer[order], eid[order], ts[order]
    offsets = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(node, minlength=num_nodes), out=offsets[1:])

    as_i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
    return TemporalCSR(
        offsets=as_i32(offsets),
        nbr=as_i32(peer),
        eid=as_i32(eid),
        ts=as_i32(time_keys(ts)),
        segment_bisect_steps=_segment_steps(offsets),
    )
