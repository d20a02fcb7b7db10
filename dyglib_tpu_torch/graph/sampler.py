"""Temporal neighbor sampling on the device.

Counterpart of ``dyglib_tpu/graph/sampler.py`` for the ``recent`` and
``uniform`` strategies: ``window_bounds`` (a batched, fixed-step binary
search over each node's time-sorted CSR segment for the strictly-before
(t' < t) history), ``sample_recent``, ``sample_uniform``,
``sample_multi_hop`` and ``fetch_entry_windows``. Every operation is a
fixed-shape batch of tensor ops. Semantics:

  * neighbor visibility is strictly-before (t' < t);
  * ``recent`` returns the last K interactions RIGHT-ALIGNED, zero padding
    at the front;
  * ``uniform`` draws K with replacement, uniformly over the window, and
    sorts them by time (flat index); a row is all valid or all padded;
  * empty windows yield all-zero rows (id 0 = padding sentinel).

``uniform`` draws from a ``torch.Generator`` on the CSR's device where the
JAX package takes a ``jax.random`` key: the two match in distribution, not
in bits. ``time_interval_aware`` comes with CAWN; asking for it raises.
The TPU's packed ``csr.pack`` row gather is not ported: rows are gathered
from the flat arrays.
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


def _uniform_indices(
    lo: torch.Tensor, hi: torch.Tensor, k: int, gen: torch.Generator
) -> tuple[torch.Tensor, torch.Tensor]:
    """k draws with replacement, uniform over each window [lo, hi), sorted
    (flat indices sort as their entries' times: a window is one node's
    time-sorted run); rows are all valid or all padded."""
    cnt = hi - lo
    u = torch.rand((*lo.shape, k), generator=gen, device=lo.device, dtype=torch.float64)
    span = cnt.clamp_min(1)[..., None]
    r = torch.minimum((u * span).floor().to(torch.int32), span - 1)
    idx = torch.sort(lo[..., None] + r, dim=-1).values
    return idx, (cnt > 0)[..., None].expand(idx.shape)


SAMPLE_STRATEGIES = ("recent", "uniform")


def check_strategy(strategy: str) -> None:
    """Raise for a sample strategy the port does not run."""
    if strategy == "time_interval_aware":
        raise ValueError(
            "sample strategy 'time_interval_aware' is not ported: it comes with CAWN "
            "(ROADMAP.md Queue 1)"
        )
    if strategy not in SAMPLE_STRATEGIES:
        raise ValueError(f"unknown sample strategy {strategy!r}; one of {SAMPLE_STRATEGIES}")


def _sampled_indices(lo, hi, k: int, strategy: str, gen: torch.Generator | None):
    if strategy == "recent":
        return _recent_indices(lo, hi, k)
    if gen is None:
        raise ValueError(f"the {strategy!r} strategy draws from a torch.Generator: pass gen")
    return _uniform_indices(lo, hi, k, gen)


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
    from ``csr.nbr_hi``, one gather per row. ``uniform`` draws every hop
    from ``gen`` (on the CSR's device), hop after hop.

    ``return_windows``: also return each hop's flat window base
    (start = hi - k, that hop's query shape): under ``recent`` the sampled
    indices are exactly start + j, the contiguous ranges
    ``fetch_entry_windows`` reads. None under ``uniform``.
    """
    check_strategy(strategy)
    blocks: list[NeighborBlock] = []
    wins: list[torch.Tensor] = []
    b = node_ids.shape[0]
    lo, hi = window_bounds(csr, node_ids, times)
    for h in range(num_hops):
        idx, valid = _sampled_indices(lo, hi, k, strategy, gen)
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
