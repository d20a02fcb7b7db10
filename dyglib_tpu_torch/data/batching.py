"""Chronological fixed-shape batching.

Counterpart of ``dyglib_tpu/data/batching.py``. Batches are never shuffled
(chronological order is load-bearing for temporal causality); the last
partial batch is padded up to ``batch_size`` by repeating its last real
row and carries a validity mask, so every batch has one shape.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import numpy as np

from .containers import EdgeStream


@dataclasses.dataclass
class Batch:
    """One fixed-shape chronological slice of an edge stream."""

    src: np.ndarray  # (B,) int
    dst: np.ndarray  # (B,) int
    ts: np.ndarray  # (B,) float
    eid: np.ndarray  # (B,) int
    label: np.ndarray  # (B,) float
    valid: np.ndarray  # (B,) bool — False on padded tail rows
    start: int  # index of first real row in the stream
    stop: int  # index one past the last real row

    @property
    def num_valid(self) -> int:
        return self.stop - self.start


def chronological_batches(stream: EdgeStream, batch_size: int) -> Iterator[Batch]:
    """Yield fixed-shape chronological batches; the final one is padded."""
    n = stream.num_interactions
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        idx = np.minimum(np.arange(start, start + batch_size), n - 1)
        valid = np.arange(start, start + batch_size) < n
        yield Batch(
            src=stream.src[idx],
            dst=stream.dst[idx],
            ts=stream.ts[idx],
            eid=stream.eid[idx],
            label=stream.label[idx],
            valid=valid,
            start=start,
            stop=stop,
        )
