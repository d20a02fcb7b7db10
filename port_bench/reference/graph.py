"""Temporal neighbourhoods and negatives, worked out from the stream.

Semantics (DyGLib's, which the port follows):
  * an interaction (u, v, t) is in the history of u and of v;
  * a query (n, t) sees n's interactions strictly before t (time keys:
    ceil of the times); among equal times the earlier edge comes first;
  * ``recent``: the last K of them, oldest first, RIGHT-aligned, with
    zero padding (node 0, edge 0, time 0) in front;
  * a TGAT hop's queries are the previous hop's entries at those
    entries' own times; a padded entry has no history;
  * DyGFormer's sequence: the node itself (edge 0, the query time), then
    its last ``maxlen - 1`` interactions oldest first, LEFT-aligned, zero
    padded at the end;
  * random negatives: ``np.random.RandomState(seed)``, per batch of n real
    rows a draw of n source indices, then n destination indices, over the
    sorted unique ids of the sampler's stream; the destinations are used,
    padded rows repeat the last one.
"""
from __future__ import annotations

import numpy as np
import torch


def time_keys(ts: np.ndarray) -> np.ndarray:
    return np.ceil(np.asarray(ts, dtype=np.float64)).astype(np.int64)


class History:
    """Every node's interactions, time-ordered, from one edge stream."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, ts: np.ndarray, eid: np.ndarray,
                 num_nodes: int):
        e = len(src)
        node = np.concatenate([src, dst]).astype(np.int64)
        peer = np.concatenate([dst, src]).astype(np.int64)
        pos = np.concatenate([np.arange(e), np.arange(e)])
        keys = np.concatenate([time_keys(ts)] * 2)
        order = np.lexsort((pos, keys, node))  # by node, then time, then edge order
        self.node, self.peer = node[order], peer[order]
        self.eid = np.concatenate([eid, eid]).astype(np.int64)[order]
        self.t = keys[order]
        self.start = np.searchsorted(self.node, np.arange(num_nodes + 1), side="left")
        self.base = int(self.t.max()) + 2 if e else 2
        self._comp = self.node * self.base + self.t

    def before(self, nodes: np.ndarray, t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(lo, hi): the entries of each node strictly before its time."""
        nodes = np.asarray(nodes, dtype=np.int64)
        t = np.minimum(np.asarray(t, dtype=np.int64), self.base - 1)
        lo = self.start[nodes]
        hi = np.searchsorted(self._comp, nodes * self.base + t, side="left")
        return lo, np.maximum(hi, lo)

    def recent(self, nodes: np.ndarray, t: np.ndarray, k: int):
        """(ids, eids, times, mask), each (Q, k): right-aligned recent neighbours."""
        lo, hi = self.before(nodes, t)
        idx = hi[:, None] - k + np.arange(k)[None, :]
        mask = idx >= lo[:, None]
        safe = np.clip(idx, 0, max(len(self.peer) - 1, 0))
        pick = lambda a: np.where(mask, a[safe], 0) if len(a) else np.zeros_like(idx)
        return pick(self.peer), pick(self.eid), pick(self.t), mask

    def sequence(self, nodes: np.ndarray, t: np.ndarray, length: int):
        """(ids, eids, times), each (Q, length): the node, then its last
        length - 1 interactions oldest first, zero padded at the end."""
        lo, hi = self.before(nodes, t)
        k = length - 1
        start = np.maximum(lo, hi - k)
        idx = start[:, None] + np.arange(k)[None, :]
        mask = idx < hi[:, None]
        safe = np.clip(idx, 0, max(len(self.peer) - 1, 0))
        pick = lambda a: np.where(mask, a[safe], 0) if len(a) else np.zeros_like(idx)
        nodes = np.asarray(nodes, dtype=np.int64)
        return (np.concatenate([nodes[:, None], pick(self.peer)], 1),
                np.concatenate([np.zeros_like(nodes)[:, None], pick(self.eid)], 1),
                np.concatenate([np.asarray(t, dtype=np.int64)[:, None], pick(self.t)], 1))


def occurrences(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """For each row, how often each entry of q occurs in k: (R, Lq) float32.
    By sorting k and two binary searches per entry."""
    ks = torch.sort(k.to(torch.int64), dim=1).values.contiguous()
    q = q.to(torch.int64).contiguous()
    hi = torch.searchsorted(ks, q, right=True)
    lo = torch.searchsorted(ks, q, right=False)
    return (hi - lo).to(torch.float32)


class RandomNegatives:
    """DyGLib's random negative sampler, reduced to what a run uses."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, seed: int):
        self.src_ids = np.unique(src)
        self.dst_ids = np.unique(dst)
        self.state = np.random.RandomState(seed)

    def destinations(self, n_real: int, batch_size: int) -> np.ndarray:
        self.state.randint(0, len(self.src_ids), n_real)
        di = self.state.randint(0, len(self.dst_ids), n_real)
        out = np.empty(batch_size, dtype=np.int64)
        out[:n_real] = self.dst_ids[di]
        out[n_real:] = out[n_real - 1] if n_real else 0
        return out


def batch_rows(n: int, batch_size: int, index: int):
    """(rows, valid) of chronological batch ``index`` of a stream of n
    edges: the last one repeats its last row."""
    rows = np.arange(index * batch_size, (index + 1) * batch_size)
    return np.minimum(rows, n - 1), rows < n
