"""Negative edge sampler, random strategy.

Counterpart of ``dyglib_tpu/graph/neg_sampler.py``: host numpy, uniform
draws over the split's unique src/dst id tables from a seeded
``np.random.RandomState``, so one seed gives the same negatives in both
packages. ``reset_random_state`` restores the seeded stream so every eval
sweep sees the same negatives. The historical and inductive strategies
come with the evaluation CLI.
"""
from __future__ import annotations

import numpy as np


class NegativeEdgeSampler:
    def __init__(self, src_node_ids: np.ndarray, dst_node_ids: np.ndarray, seed: int | None = None):
        self.seed = seed
        self.unique_src_node_ids = np.unique(src_node_ids)
        self.unique_dst_node_ids = np.unique(dst_node_ids)
        self.random_state = np.random.RandomState(seed)

    def reset_random_state(self) -> None:
        self.random_state = np.random.RandomState(self.seed)

    def sample(self, size: int) -> tuple[np.ndarray, np.ndarray]:
        """(neg_src, neg_dst), uniform over the unique id tables."""
        si = self.random_state.randint(0, len(self.unique_src_node_ids), size)
        di = self.random_state.randint(0, len(self.unique_dst_node_ids), size)
        return self.unique_src_node_ids[si], self.unique_dst_node_ids[di]
