"""EdgeBank: the non-parametric link-prediction baseline (evaluation only).

Counterpart of ``dyglib_tpu/models/edgebank.py``, on the device: an edge
(src, dst) is predicted 1.0 iff it is in a memory built from the history.
Pairs are int64 keys src << 32 | dst; the memory is their
``torch.unique`` (sorted), membership a ``torch.searchsorted``. Memory
modes:

  * ``unlimited_memory``: every edge seen;
  * ``time_window_memory`` with ``fixed_proportion``: the edges in the last
    ``time_window_proportion`` quantile of history time (numpy's linear
    quantile);
  * ``time_window_memory`` with ``repeat_interval``: the window is the sum
    over recurring edges of their mean repeat interval, divided by the
    number of distinct edges (the reference's divisor), in float64: the
    per-edge means are segment means over the stable-sorted keys;
  * ``repeat_threshold_memory``: the edges seen at least as often as the
    mean edge.

EdgeBank has no parameters and does not train.
"""
from __future__ import annotations

import torch

MEMORY_MODES = ("unlimited_memory", "time_window_memory", "repeat_threshold_memory")


def pair_keys(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(src, dst) -> int64 keys src << 32 | dst."""
    return (src.long() << 32) | dst.long()


def edge_bank_unlimited_memory(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    return torch.unique(pair_keys(src, dst))


def _linear_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """numpy's default (linear) quantile of a 1-D float64 tensor."""
    v = torch.sort(x).values
    n = v.shape[0]
    index = (n - 1) * q
    lo = min(max(int(index // 1), 0), n - 1)
    hi = min(lo + 1, n - 1)
    t = index - lo
    a, b = v[lo], v[hi]
    diff = b - a
    return b - diff * (1 - t) if t >= 0.5 else a + diff * t


def edge_bank_time_window_memory(
    src: torch.Tensor, dst: torch.Tensor, ts: torch.Tensor, time_window_mode: str,
    time_window_proportion: float,
) -> torch.Tensor:
    ts = ts.to(torch.float64)
    end = ts.max()
    if time_window_mode == "fixed_proportion":
        start = _linear_quantile(ts, 1 - time_window_proportion)
    elif time_window_mode == "repeat_interval":
        keys = pair_keys(src, dst)
        order = torch.sort(keys, stable=True).indices
        k, t = keys[order], ts[order]
        # consecutive gaps within each edge (the stable sort keeps an edge's
        # occurrences in time order), averaged per edge, summed over edges
        same = k[1:] == k[:-1]
        gaps, gap_keys = (t[1:] - t[:-1])[same], k[1:][same]
        sum_means = torch.zeros((), dtype=torch.float64, device=ts.device)
        if gaps.numel():
            # segment sums as differences of one cumulative sum (the same
            # order on every run, unlike atomic adds)
            _, counts = torch.unique_consecutive(gap_keys, return_counts=True)
            cs = torch.cumsum(gaps, 0)[torch.cumsum(counts, 0) - 1]
            sums = cs - torch.cat([cs.new_zeros(1), cs[:-1]])
            sum_means = (sums / counts).sum()
        start = end - sum_means / torch.unique(keys).numel()
    else:
        raise ValueError(f"unknown time_window_mode {time_window_mode!r}")
    keep = (ts >= start) & (ts <= end)
    return edge_bank_unlimited_memory(src[keep], dst[keep])


def edge_bank_repeat_threshold_memory(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The edges seen at least as often as the mean edge: count >= sum / n,
    compared as count * n >= sum in integers (the same answer as numpy's
    float mean, on any device)."""
    uniq, counts = torch.unique(pair_keys(src, dst), return_counts=True)
    return uniq[counts * counts.numel() >= counts.sum()]


def edge_bank_memory(
    src: torch.Tensor, dst: torch.Tensor, ts: torch.Tensor,
    edge_bank_memory_mode: str = "unlimited_memory",
    time_window_mode: str = "fixed_proportion",
    time_window_proportion: float = 0.15,
) -> torch.Tensor:
    """The sorted int64 keys of the history's remembered edges."""
    if edge_bank_memory_mode == "unlimited_memory":
        return edge_bank_unlimited_memory(src, dst)
    if edge_bank_memory_mode == "time_window_memory":
        return edge_bank_time_window_memory(src, dst, ts, time_window_mode,
                                            time_window_proportion)
    if edge_bank_memory_mode == "repeat_threshold_memory":
        return edge_bank_repeat_threshold_memory(src, dst)
    raise ValueError(f"unknown edge_bank_memory_mode {edge_bank_memory_mode!r}; "
                     f"one of {MEMORY_MODES}")


def edge_bank_predict(memory: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """float64 1.0 where (src, dst) is in ``memory``, else 0.0."""
    keys = pair_keys(src, dst)
    if memory.numel() == 0:
        return torch.zeros(keys.shape, dtype=torch.float64, device=keys.device)
    idx = torch.searchsorted(memory, keys).clamp_max(memory.numel() - 1)
    return (memory[idx] == keys).to(torch.float64)


def edge_bank_link_prediction(
    history: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    positive_edges: tuple[torch.Tensor, torch.Tensor],
    negative_edges: tuple[torch.Tensor, torch.Tensor],
    edge_bank_memory_mode: str = "unlimited_memory",
    time_window_mode: str = "fixed_proportion",
    time_window_proportion: float = 0.15,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The memory of ``history`` = (src, dst, ts) tensors, and the
    positive and negative edges' probabilities."""
    memory = edge_bank_memory(*history, edge_bank_memory_mode=edge_bank_memory_mode,
                              time_window_mode=time_window_mode,
                              time_window_proportion=time_window_proportion)
    return edge_bank_predict(memory, *positive_edges), edge_bank_predict(memory, *negative_edges)
