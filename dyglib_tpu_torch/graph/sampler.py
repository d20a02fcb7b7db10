"""Temporal neighbor sampling on the device.

Counterpart of ``dyglib_tpu/graph/sampler.py``: ``window_bounds`` (a
batched, fixed-step binary search over each node's time-sorted CSR segment
for the strictly-before (t' < t) history), ``sample_recent``,
``sample_uniform``, ``sample_time_interval_aware``, the strategy dispatch
``sample_neighbors``, ``sample_multi_hop`` and ``fetch_entry_windows``.
Every operation is a fixed-shape batch of tensor ops. Semantics:

  * neighbor visibility is strictly-before (t' < t);
  * ``recent`` returns the last K interactions RIGHT-ALIGNED, zero padding
    at the front;
  * ``uniform`` draws K with replacement, uniformly over the window, and
    sorts them by time (flat index); a row is all valid or all padded;
  * ``time_interval_aware`` (CAWN) draws K with replacement from the
    softmax of CAWN's logits over the window, by inverse-CDF search of
    ``csr.tia_cew`` (``tia_select``), then sorts them like ``uniform``; a
    window whose weights all underflowed falls back to uniform draws;
  * empty windows yield all-zero rows (id 0 = padding sentinel).

The stochastic strategies draw from a ``torch.Generator`` on the CSR's
device where the JAX package takes a ``jax.random`` key: the two match in
distribution, not in bits. Given the same uniforms, ``tia_select`` picks
the JAX package's indices exactly. The TPU's packed ``csr.pack`` row
gather is not ported: rows are gathered from the flat arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .csr import TemporalCSR


class NeighborBlock(NamedTuple):
    """Fixed-K sampled neighborhood; rows are time-sorted where valid."""

    nbr: torch.Tensor  # (..., K) int32, 0 where padded
    eid: torch.Tensor  # (..., K) int32, 0 where padded
    ts: torch.Tensor  # (..., K) int32 time keys, 0 where padded
    mask: torch.Tensor  # (..., K) bool, True on real samples


def window_bounds(
    csr: TemporalCSR, node_ids: torch.Tensor, times: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) flat-index bounds of each node's strictly-before-t history.

    hi is the left insertion point of t in the node's time-sorted segment
    (``np.searchsorted(seg_times, t, side="left")`` offset by the segment
    start). Int32 in, int32 out.
    """
    node_ids = node_ids.long()
    lo = csr.offsets[node_ids]
    seg_hi = csr.offsets[node_ids + 1]
    t = times.to(torch.int32)
    last = max(csr.num_entries - 1, 0)
    lo_, hi_ = lo, seg_hi
    for _ in range(csr.segment_bisect_steps):
        mid = (lo_ + hi_) >> 1
        below = csr.ts[mid.clamp(0, last).long()] < t
        active = lo_ < hi_
        lo_ = torch.where(active & below, mid + 1, lo_)
        hi_ = torch.where(active & ~below, mid, hi_)
    return lo, hi_


def _gather_rows(
    csr: TemporalCSR, idx: torch.Tensor, valid: torch.Tensor
) -> tuple[NeighborBlock, torch.Tensor]:
    """(block, next-hop hi bounds) for the sampled flat indices."""
    safe = idx.clamp(0, max(csr.num_entries - 1, 0)).long()
    block = NeighborBlock(
        nbr=torch.where(valid, csr.nbr[safe], 0),
        eid=torch.where(valid, csr.eid[safe], 0),
        ts=torch.where(valid, csr.ts[safe], 0),
        mask=valid,
    )
    return block, csr.nbr_hi[safe]


def _recent_indices(
    lo: torch.Tensor, hi: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat indices of the last k window entries, right-aligned, and their
    validity."""
    idx = hi[..., None] - k + torch.arange(k, dtype=torch.int32, device=hi.device)
    return idx, idx >= lo[..., None]


def _uniform_offsets(cnt: torch.Tensor, k: int, gen: torch.Generator) -> torch.Tensor:
    """(..., k) offsets drawn uniformly from [0, max(cnt, 1))."""
    u = torch.rand((*cnt.shape, k), generator=gen, device=cnt.device, dtype=torch.float64)
    span = cnt.clamp_min(1)[..., None]
    return torch.minimum((u * span).floor().to(torch.int32), span - 1)


def _uniform_indices(
    lo: torch.Tensor, hi: torch.Tensor, k: int, gen: torch.Generator
) -> tuple[torch.Tensor, torch.Tensor]:
    """k draws with replacement, uniform over each window [lo, hi), sorted
    (flat indices sort as their entries' times: a window is one node's
    time-sorted run); rows are all valid or all padded."""
    cnt = hi - lo
    idx = torch.sort(lo[..., None] + _uniform_offsets(cnt, k, gen), dim=-1).values
    return idx, (cnt > 0)[..., None].expand(idx.shape)


def tia_select(
    csr: TemporalCSR, lo: torch.Tensor, hi: torch.Tensor, u: torch.Tensor, r: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """time_interval_aware's draws from given randomness: ``u`` (..., k)
    float32 uniforms in [0, 1) and ``r`` (..., k) int32 offsets in [0,
    max(hi - lo, 1)) for the uniform fallback. Returns the sorted flat
    indices and their validity, as the JAX package's ``_tia_indices``
    computes them from the same u and r.

    The first j in [lo, hi) with cew[j] > lo's base + u * total is the
    inverse CDF of the softmax over the window (its normalization cancels);
    ``lo`` is always a segment start, so the base is 0. A window whose
    total weight is not positive takes lo + r."""
    if csr.tia_cew is None:
        raise ValueError("time_interval_aware needs a CSR built with with_tia=True")
    cew = csr.tia_cew
    last = max(csr.num_entries - 1, 0)
    total = cew[(hi - 1).clamp(0, last).long()]
    target = u * total[..., None]
    lo_b = lo[..., None].expand(target.shape)
    hi_b = hi[..., None].expand(target.shape)
    lo_, hi_ = lo_b, hi_b
    for _ in range(csr.segment_bisect_steps):
        mid = (lo_ + hi_) >> 1
        below = cew[mid.clamp(0, last).long()] <= target
        active = lo_ < hi_
        lo_ = torch.where(active & below, mid + 1, lo_)
        hi_ = torch.where(active & ~below, mid, hi_)
    idx = torch.minimum(torch.maximum(lo_, lo_b), torch.maximum(hi_b - 1, lo_b))
    idx = torch.where((total <= 0.0)[..., None], lo_b + r, idx)
    idx = torch.sort(idx, dim=-1).values
    return idx, (hi > lo)[..., None].expand(idx.shape)


def _tia_indices(
    csr: TemporalCSR, lo: torch.Tensor, hi: torch.Tensor, k: int, gen: torch.Generator
) -> tuple[torch.Tensor, torch.Tensor]:
    """k time_interval_aware draws from ``gen`` (see ``tia_select``)."""
    u = torch.rand((*lo.shape, k), generator=gen, device=lo.device, dtype=torch.float32)
    return tia_select(csr, lo, hi, u, _uniform_offsets(hi - lo, k, gen))


SAMPLE_STRATEGIES = ("recent", "uniform", "time_interval_aware")


def check_strategy(strategy: str) -> None:
    """Raise for an unknown sample strategy."""
    if strategy not in SAMPLE_STRATEGIES:
        raise ValueError(f"unknown sample strategy {strategy!r}; one of {SAMPLE_STRATEGIES}")


def _sampled_indices(csr, lo, hi, k: int, strategy: str, gen: torch.Generator | None):
    check_strategy(strategy)
    if strategy == "recent":
        return _recent_indices(lo, hi, k)
    if gen is None:
        raise ValueError(f"the {strategy!r} strategy draws from a torch.Generator: pass gen")
    if strategy == "uniform":
        return _uniform_indices(lo, hi, k, gen)
    return _tia_indices(csr, lo, hi, k, gen)


def sample_recent(
    csr: TemporalCSR, node_ids: torch.Tensor, times: torch.Tensor, k: int
) -> NeighborBlock:
    """Most recent k interactions, right-aligned."""
    lo, hi = window_bounds(csr, node_ids, times)
    return _gather_rows(csr, *_recent_indices(lo, hi, k))[0]


def sample_uniform(
    csr: TemporalCSR, node_ids: torch.Tensor, times: torch.Tensor, k: int,
    gen: torch.Generator,
) -> NeighborBlock:
    """k uniform draws with replacement, sorted by time."""
    lo, hi = window_bounds(csr, node_ids, times)
    return _gather_rows(csr, *_uniform_indices(lo, hi, k, gen))[0]


def sample_time_interval_aware(
    csr: TemporalCSR, node_ids: torch.Tensor, times: torch.Tensor, k: int,
    gen: torch.Generator,
) -> NeighborBlock:
    """k draws from the softmax of CAWN's logits over the window, sorted by
    time (see ``tia_select``)."""
    lo, hi = window_bounds(csr, node_ids, times)
    return _gather_rows(csr, *_tia_indices(csr, lo, hi, k, gen))[0]


def sample_neighbors(
    csr: TemporalCSR, node_ids: torch.Tensor, times: torch.Tensor, k: int,
    strategy: str = "recent", gen: torch.Generator | None = None,
) -> NeighborBlock:
    """One hop of k neighbors under ``strategy``; the stochastic ones draw
    from ``gen`` (on the CSR's device)."""
    lo, hi = window_bounds(csr, node_ids, times)
    return _gather_rows(csr, *_sampled_indices(csr, lo, hi, k, strategy, gen))[0]


def sample_multi_hop(
    csr: TemporalCSR,
    node_ids: torch.Tensor,
    times: torch.Tensor,
    k: int,
    num_hops: int,
    strategy: str = "recent",
    return_windows: bool = False,
    gen: torch.Generator | None = None,
) -> list[NeighborBlock] | tuple[list[NeighborBlock], list[torch.Tensor] | None]:
    """Recursive fan-out: hop h has shape (B, k**h).

    Hop h+1 queries are the flattened ids/times of hop h; padded entries
    (id 0) get empty windows and stay padded. Hop h+1's window bounds come
    from ``csr.nbr_hi``, one gather per row. The stochastic strategies draw
    every hop from ``gen`` (on the CSR's device), hop after hop.

    ``return_windows``: also return each hop's flat window base
    (start = hi - k, that hop's query shape): under ``recent`` the sampled
    indices are exactly start + j, the contiguous ranges
    ``fetch_entry_windows`` reads. None under the stochastic strategies.
    """
    blocks: list[NeighborBlock] = []
    wins: list[torch.Tensor] = []
    b = node_ids.shape[0]
    lo, hi = window_bounds(csr, node_ids, times)
    for h in range(num_hops):
        idx, valid = _sampled_indices(csr, lo, hi, k, strategy, gen)
        wins.append(hi - k)
        blk, nhi = _gather_rows(csr, idx, valid)
        blocks.append(blk)
        if h + 1 == num_hops:
            break
        lo = csr.offsets[blk.nbr.reshape(b, -1).long()]
        hi = torch.where(valid.reshape(b, -1), nhi.reshape(b, -1), lo)
    if return_windows:
        return blocks, (wins if strategy == "recent" else None)
    return blocks


def fetch_entry_windows(csr: TemporalCSR, start: torch.Tensor, k: int) -> torch.Tensor:
    """(..., k, Dn + De) rows of ``csr.feat_entry`` for contiguous windows.

    ``start``: flat window base per query (hi - k from the recent sampler;
    may be negative by up to k, which the table's zero guard rows absorb,
    so row j is exactly entry start + j). Invalid positions return guard
    zeros or other entries' rows; callers mask with the block's validity,
    which reproduces the row-gather path's id-0 zero rows exactly.
    """
    if csr.feat_entry is None:
        raise ValueError("the CSR was built without feat_entry")
    pad = csr.feat_entry_guard_pad
    if k > pad:
        raise ValueError(f"window of {k} entries exceeds the feat_entry guard pad {pad}")
    flat = start.reshape(-1).to(torch.int32) + pad
    idx = flat[:, None] + torch.arange(k, dtype=torch.int32, device=start.device)
    win = csr.feat_entry[idx.long()]  # (Q, k, D) row gather
    return win.reshape(*start.shape, k, csr.feat_entry.shape[1])
