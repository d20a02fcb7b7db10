"""Edge-stream container for continuous-time dynamic graphs.

Counterpart of ``dyglib_tpu/data/containers.py``: five parallel host
arrays describing a chronologically sorted interaction stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class EdgeStream:
    """A chronologically ordered stream of temporal interactions.

    Node id 0 and edge id 0 are reserved padding sentinels.
    """

    src: np.ndarray  # (E,) int64 source node ids
    dst: np.ndarray  # (E,) int64 destination node ids
    ts: np.ndarray  # (E,) float64 interaction times, non-decreasing
    eid: np.ndarray  # (E,) int64 edge ids (1-based; 0 = padding)
    label: np.ndarray  # (E,) float edge/state labels

    def __post_init__(self):
        e = len(self.src)
        if not len(self.dst) == len(self.ts) == len(self.eid) == len(self.label) == e:
            raise ValueError("EdgeStream arrays must have equal lengths")

    @property
    def num_interactions(self) -> int:
        return len(self.src)

    def slice(self, start: int, stop: int) -> "EdgeStream":
        return EdgeStream(
            src=self.src[start:stop],
            dst=self.dst[start:stop],
            ts=self.ts[start:stop],
            eid=self.eid[start:stop],
            label=self.label[start:stop],
        )

    def mask(self, keep: np.ndarray) -> "EdgeStream":
        return EdgeStream(
            src=self.src[keep],
            dst=self.dst[keep],
            ts=self.ts[keep],
            eid=self.eid[keep],
            label=self.label[keep],
        )
