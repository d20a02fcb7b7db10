"""Negative edge samplers: random, historical and inductive.

Counterpart of ``dyglib_tpu/graph/neg_sampler.py``, copied: host numpy in
both packages (negatives are inputs to a step, never computed on the
device), so one seed gives the same negatives, array for array.

  * random: uniform draws over the split's unique src/dst id tables from a
    seeded ``np.random.RandomState``;
  * historical: edges seen before the batch window minus the batch's own
    edges, topped up with collision-checked random pairs when too few;
  * inductive: as historical, less the edges observed up to
    ``last_observed_time``.

The historical pool grows incrementally along a chronological sweep;
``reset_random_state`` restores the seeded stream and rewinds the pool, so
every eval sweep sees the same negatives. ``build_eval_neg_samplers`` is
the evaluation CLI's layout of the four eval samplers.
"""
from __future__ import annotations

import numpy as np


class NegativeEdgeSampler:
    def __init__(
        self,
        src_node_ids: np.ndarray,
        dst_node_ids: np.ndarray,
        interact_times: np.ndarray | None = None,
        last_observed_time: float | None = None,
        negative_sample_strategy: str = "random",
        seed: int | None = None,
    ):
        if negative_sample_strategy not in ("random", "historical", "inductive"):
            raise ValueError(f"unknown negative_sample_strategy {negative_sample_strategy!r}")
        if negative_sample_strategy != "random" and (interact_times is None or seed is None):
            raise ValueError(f"the {negative_sample_strategy!r} strategy needs interact_times "
                             "and a seed")
        self.seed = seed
        self.negative_sample_strategy = negative_sample_strategy
        self.src_node_ids = np.asarray(src_node_ids)
        self.dst_node_ids = np.asarray(dst_node_ids)
        self.interact_times = None if interact_times is None else np.asarray(interact_times)
        self.unique_src_node_ids = np.unique(src_node_ids)
        self.unique_dst_node_ids = np.unique(dst_node_ids)
        self.last_observed_time = last_observed_time

        if self.interact_times is not None:
            self.earliest_time = float(self.interact_times.min())
            # interactions in chronological order, for the incremental pool
            self._order = np.argsort(self.interact_times, kind="stable")
            self._sorted_times = self.interact_times[self._order]
            self._sorted_keys = self._edge_keys(
                self.src_node_ids[self._order], self.dst_node_ids[self._order]
            )
            e = len(self._order)
            # the historical pool: unique edges in first-seen order
            self._pool_src = np.empty(e, dtype=np.int64)
            self._pool_dst = np.empty(e, dtype=np.int64)
            self._pool_ind_ok = np.empty(e, dtype=bool)
            self._reset_pool()

        if negative_sample_strategy == "inductive":
            if last_observed_time is None:
                raise ValueError("the 'inductive' strategy needs last_observed_time")
            self.observed_edges = self.get_unique_edges_between_start_end_time(
                self.earliest_time, last_observed_time
            )
            self._observed_keys = {(int(a) << 32) | int(b) for a, b in self.observed_edges}

        self.random_state = np.random.RandomState(seed)

    @staticmethod
    def _edge_keys(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """(src, dst) -> one int64 key (node ids are < 2**31)."""
        return (src.astype(np.int64) << 32) | dst.astype(np.int64)

    def _reset_pool(self) -> None:
        self._ptr = 0
        self._pool_n = 0
        self._seen: set[int] = set()

    def _advance_pool(self, t_start: float) -> None:
        """Fold every interaction with t <= t_start into the pool."""
        new_ptr = int(np.searchsorted(self._sorted_times, t_start, side="right"))
        if new_ptr < self._ptr:  # the sweep restarted from an earlier time
            self._reset_pool()
        seen, n = self._seen, self._pool_n
        inductive = self.negative_sample_strategy == "inductive"
        for i in range(self._ptr, new_ptr):
            k = int(self._sorted_keys[i])
            if k not in seen:
                seen.add(k)
                self._pool_src[n] = k >> 32
                self._pool_dst[n] = k & 0xFFFFFFFF
                self._pool_ind_ok[n] = k not in self._observed_keys if inductive else True
                n += 1
        self._pool_n = n
        self._ptr = new_ptr

    def reset_random_state(self) -> None:
        """Restore the seeded stream and rewind the pool, so that a fresh
        chronological sweep draws the same negatives."""
        self.random_state = np.random.RandomState(self.seed)
        if self.interact_times is not None:
            self._reset_pool()

    def get_unique_edges_between_start_end_time(
        self, start_time: float, end_time: float
    ) -> set[tuple[int, int]]:
        sel = (self.interact_times >= start_time) & (self.interact_times <= end_time)
        return set(zip(self.src_node_ids[sel].tolist(), self.dst_node_ids[sel].tolist()))

    def sample(
        self,
        size: int,
        batch_src_node_ids: np.ndarray | None = None,
        batch_dst_node_ids: np.ndarray | None = None,
        current_batch_start_time: float = 0.0,
        current_batch_end_time: float = 0.0,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(neg_src, neg_dst) of ``size`` negatives under the strategy; the
        historical and inductive ones need the batch's edges and time range."""
        if self.negative_sample_strategy == "random":
            return self.random_sample(size)
        return self._conditioned_sample(
            size, batch_src_node_ids, batch_dst_node_ids, current_batch_start_time,
            current_batch_end_time, inductive=self.negative_sample_strategy == "inductive",
        )

    def random_sample(self, size: int) -> tuple[np.ndarray, np.ndarray]:
        """Uniform over the split's unique src and dst id tables."""
        si = self.random_state.randint(0, len(self.unique_src_node_ids), size)
        di = self.random_state.randint(0, len(self.unique_dst_node_ids), size)
        return self.unique_src_node_ids[si], self.unique_dst_node_ids[di]

    def random_sample_with_collision_check(
        self, size: int, batch_src_node_ids: np.ndarray, batch_dst_node_ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Uniform pairs that are not edges of the batch, by rejection."""
        batch_edges = set(zip(batch_src_node_ids.tolist(), batch_dst_node_ids.tolist()))
        out_src, out_dst = [], []
        while len(out_src) < size:
            want = size - len(out_src)
            s, d = self.random_sample(max(2 * want, 16))
            for a, b in zip(s.tolist(), d.tolist()):
                if (a, b) not in batch_edges:
                    out_src.append(a)
                    out_dst.append(b)
                    if len(out_src) == size:
                        break
        return np.array(out_src, dtype=np.int64), np.array(out_dst, dtype=np.int64)

    def _conditioned_sample(
        self,
        size: int,
        batch_src_node_ids: np.ndarray,
        batch_dst_node_ids: np.ndarray,
        current_batch_start_time: float,
        current_batch_end_time: float,
        inductive: bool,
    ) -> tuple[np.ndarray, np.ndarray]:
        self._advance_pool(current_batch_start_time)
        # the batch's own edges: the [start, end] window of the sorted stream
        lo = int(np.searchsorted(self._sorted_times, current_batch_start_time, "left"))
        hi = int(np.searchsorted(self._sorted_times, current_batch_end_time, "right"))
        current_keys = np.unique(self._sorted_keys[lo:hi])

        n = self._pool_n
        keys = self._edge_keys(self._pool_src[:n], self._pool_dst[:n])
        mask = ~np.isin(keys, current_keys)
        if inductive:
            mask &= self._pool_ind_ok[:n]
        pool_src = self._pool_src[:n][mask]
        pool_dst = self._pool_dst[:n][mask]

        if size > len(pool_src):
            fill_src, fill_dst = self.random_sample_with_collision_check(
                size - len(pool_src), batch_src_node_ids, batch_dst_node_ids
            )
            return np.concatenate([fill_src, pool_src]), np.concatenate([fill_dst, pool_dst])
        pick = self.random_state.choice(len(pool_src), size=size, replace=False)
        return pool_src[pick], pool_dst[pick]


def build_eval_neg_samplers(data, strategy: str = "random") -> tuple[NegativeEdgeSampler, ...]:
    """The four eval samplers (val, new-node val, test, new-node test; seeds
    0-3) under ``strategy``, in the evaluation CLI's layout
    (``dyglib_tpu/runners.py::_build_eval_neg_samplers``): the historical
    and inductive ones see their split's interaction times, and the
    inductive ones treat the edges up to the end of train (val samplers)
    or of val (test samplers) as observed. ``data`` is a
    ``LinkPredictionData``."""
    if strategy == "random":
        return (
            NegativeEdgeSampler(data.full.src, data.full.dst, seed=0),
            NegativeEdgeSampler(data.new_node_val.src, data.new_node_val.dst, seed=1),
            NegativeEdgeSampler(data.full.src, data.full.dst, seed=2),
            NegativeEdgeSampler(data.new_node_test.src, data.new_node_test.dst, seed=3),
        )

    def make(stream, last, seed):
        return NegativeEdgeSampler(stream.src, stream.dst, interact_times=stream.ts,
                                   last_observed_time=last, negative_sample_strategy=strategy,
                                   seed=seed)

    train_end, val_end = float(data.train.ts[-1]), float(data.val.ts[-1])
    return (
        make(data.full, train_end, 0),
        make(data.new_node_val, train_end, 1),
        make(data.full, val_end, 2),
        make(data.new_node_test, val_end, 3),
    )
