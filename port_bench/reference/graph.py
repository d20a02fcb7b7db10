"""Temporal neighbourhoods and negatives, worked out from the stream.

Semantics (DyGLib's, which the port follows):
  * an interaction (u, v, t) is in the history of u and of v;
  * a query (n, t) sees n's interactions strictly before t (time keys:
    ceil of the times); among equal times the earlier edge comes first;
  * ``recent``: the last K of them, oldest first, RIGHT-aligned, with
    zero padding (node 0, edge 0, time 0) in front;
  * ``uniform``: K draws with replacement, uniform over the window, sorted
    by position (oldest first); a row is all valid or all padded;
  * ``time_interval_aware`` (CAWN's): K draws with replacement from the
    softmax over the window of CAWN's logits v_i = exp(alpha dt_i) /
    sum_{j<=i} exp(alpha dt_j), dt_i the entry's raw time less the node's
    latest (v_i = -1e10 where that sum underflowed to 0), sorted; a window
    whose weights all underflowed draws uniformly;
  * a TGAT hop's queries are the previous hop's entries at those
    entries' own times; a padded entry has no history;
  * DyGFormer's sequence: the node itself (edge 0, the query time), then
    its last ``maxlen - 1`` interactions oldest first, LEFT-aligned, zero
    padded at the end;
  * random negatives: ``np.random.RandomState(seed)``, per batch of n real
    rows a draw of n source indices, then n destination indices, over the
    sorted unique ids of the sampler's stream; the destinations are used,
    padded rows repeat the last one.

Departures from DyGLib, as in the port: the draws of ``uniform`` and
``time_interval_aware`` come from a ``torch.Generator`` on the device,
not from ``np.random``: per hop, for all its queries at once (padded and
empty rows included), TIA's float32 uniforms u of shape (queries, K),
then the float64 uniforms of both strategies' offsets r = floor(u64 x
max(n, 1)) into a window of n entries. A TIA draw is the inverse CDF of
the softmax: the first entry whose cumulative weight sum_{j<=i} exp(v_j),
kept in float32, exceeds u x the window's total; the softmax's
normalisation cancels (a window is a prefix of the node's history). The
float64 sums are taken as one running sum over the whole stream less the
part before each node, so the float32 weights, and every pick, are the
port's bit for bit; DyGLib normalises per node in float32.
"""
from __future__ import annotations

import numpy as np
import torch

# DyGLib's --time_scaling_factor default: time_interval_aware's alpha
TIA_ALPHA = 1e-6


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
        self.ts = np.concatenate([ts, ts]).astype(np.float64)[order]  # raw times
        self.start = np.searchsorted(self.node, np.arange(num_nodes + 1), side="left")
        self.base = int(self.t.max()) + 2 if e else 2
        self._comp = self.node * self.base + self.t
        self._tia: dict[float, tuple[np.ndarray, np.ndarray]] = {}

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

    def sample(self, strategy: str, nodes: np.ndarray, t: np.ndarray, k: int, gen=None,
               shape: tuple | None = None, alpha: float = TIA_ALPHA):
        """One hop of k neighbours of each query under ``strategy``: (ids,
        eids, times, mask), each (Q, k). The random strategies draw from
        ``gen`` in the queries' shape ``shape`` (default (Q,))."""
        if strategy == "recent":
            return self.recent(nodes, t, k)
        shape = (len(nodes),) if shape is None else tuple(shape)
        if strategy == "uniform":
            return self.uniform(nodes, t, k, gen, shape)
        if strategy == "time_interval_aware":
            return self.time_interval_aware(nodes, t, k, gen, shape, alpha)
        raise ValueError(f"unknown sample strategy {strategy!r}")

    def uniform(self, nodes: np.ndarray, t: np.ndarray, k: int, gen, shape: tuple):
        """(ids, eids, times, mask), each (Q, k): k uniform draws from
        ``gen`` for the Q queries, drawn in the query shape ``shape``."""
        lo, hi = self.before(nodes, t)
        return self._picks(lo[:, None] + _offsets(hi - lo, k, gen, shape), hi > lo)

    def time_interval_aware(self, nodes: np.ndarray, t: np.ndarray, k: int, gen, shape: tuple,
                            alpha: float):
        """(ids, eids, times, mask), each (Q, k): k draws from ``gen`` by
        CAWN's weights with time scaling ``alpha``."""
        lo, hi = self.before(nodes, t)
        u = _uniforms(gen, shape + (k,), torch.float32).reshape(-1, k)
        r = _offsets(hi - lo, k, gen, shape)
        cew, key = self.tia_weights(alpha)
        total = cew[np.maximum(hi - 1, 0)] if len(cew) else np.zeros(len(lo), np.float32)
        target = u * total[:, None]  # float32, as drawn
        nodes = np.asarray(nodes, dtype=np.int64)
        # first entry of the node with weight above the target (the weights
        # rise along a node's history), within the window
        first = np.searchsorted(key, (nodes[:, None] << 32) | _order_bits(target), side="right")
        idx = np.minimum(first, np.maximum(hi - 1, lo)[:, None])
        idx = np.where((total <= 0)[:, None], lo[:, None] + r, idx)
        return self._picks(idx, hi > lo)

    def tia_weights(self, alpha: float) -> tuple[np.ndarray, np.ndarray]:
        """(cumulative weights, search keys) of every entry: the float32
        sum of exp(v_j) over the node's entries up to it, and (node << 32)
        | the weight's order bits, ascending over the whole stream."""
        if alpha not in self._tia:
            if not len(self.ts):
                self._tia[alpha] = (np.zeros(0, np.float32), np.zeros(0, np.int64))
                return self._tia[alpha]
            first = self.start[self.node]

            def node_cumsum(x):
                cs = np.cumsum(x)
                return cs - (cs[first] - x[first])

            latest = self.ts[self.start[self.node + 1] - 1]
            ew = np.exp(alpha * (self.ts - latest))
            wcs = node_cumsum(ew)
            with np.errstate(invalid="ignore", divide="ignore"):
                v = np.where(wcs > 0, ew / wcs, -1e10)
            cew = node_cumsum(np.exp(v)).astype(np.float32)
            self._tia[alpha] = (cew, (self.node << 32) | _order_bits(cew))
        return self._tia[alpha]

    def _picks(self, idx: np.ndarray, valid: np.ndarray):
        """(ids, eids, times, mask) of each row's entries ``idx``, sorted;
        rows not ``valid`` all padding."""
        idx = np.sort(idx, axis=1)
        mask = np.broadcast_to(valid[:, None], idx.shape)
        safe = np.clip(idx, 0, max(len(self.peer) - 1, 0))
        pick = lambda a: np.where(mask, a[safe], 0) if len(a) else np.zeros_like(idx)
        return pick(self.peer), pick(self.eid), pick(self.t), mask.copy()

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


def _uniforms(gen, shape: tuple, dtype) -> np.ndarray:
    """One ``torch.rand`` call of ``gen`` on its device, on the host."""
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype).cpu().numpy()


def _offsets(n: np.ndarray, k: int, gen, shape: tuple) -> np.ndarray:
    """(Q, k) offsets uniform over [0, max(n, 1)) for windows of n entries."""
    u = _uniforms(gen, shape + (k,), torch.float64).reshape(-1, k)
    span = np.maximum(np.asarray(n, np.int64), 1)[:, None]
    return np.minimum(np.floor(u * span).astype(np.int64), span - 1)


def _order_bits(x: np.ndarray) -> np.ndarray:
    """int64 keys of non-negative float32 values, in the values' order."""
    x = np.asarray(x, np.float32)
    return np.where(x > 0, x, np.float32(0)).view(np.uint32).astype(np.int64)


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
