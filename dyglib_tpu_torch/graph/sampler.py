"""Temporal neighbor-window bounds on the device.

Counterpart of ``dyglib_tpu/graph/sampler.py::window_bounds``: a batched,
fixed-step binary search over each node's time-sorted CSR segment for the
strictly-before (t' < t) history. The other strategies (uniform,
time-interval-aware, multi-hop) come with the models that use them.
"""
from __future__ import annotations

import torch

from .csr import TemporalCSR


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
