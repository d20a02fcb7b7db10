"""The benchmark's inputs: the edge stream, its splits and the sweeps.

A configuration's ``stream`` entry names its generator (``kind``) and
that generator's parameters:

  * ``bipartite``: a copy of the port's synthetic bipartite generator
    (``dyglib_tpu_torch/data/synthetic.py::make_synthetic_bipartite``: the
    same ``np.random.default_rng`` draws in the same order), a user-item
    stream such as wikipedia's;
  * ``yearly``: a non-bipartite stream in a few equal time steps, such as
    a parliament's yearly co-votes (CanParl): seats held step by step,
    each step's edges distinct pairs of the seated nodes.

The split is a copy of the port's link-prediction split
(``data/datasets.py``), so the benchmark makes its inputs itself and
hands the same arrays to the program and to the reference. Everything a
run draws comes from ``--seed`` through ``sub_seed``.
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np

FEAT_DIM = 172


def sub_seed(seed: int, tag: str, bits: int = 32) -> int:
    """A seed of ``bits`` bits for one purpose of a run, from its --seed
    (any non-negative integer, also beyond 2**32)."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [ord(c) for c in tag]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    value = (int(state[1]) << 32) | int(state[0])
    return value & ((1 << bits) - 1)


@dataclasses.dataclass
class Stream:
    """A chronological edge stream: five parallel host arrays."""

    src: np.ndarray
    dst: np.ndarray
    ts: np.ndarray
    eid: np.ndarray
    label: np.ndarray

    def __len__(self) -> int:
        return len(self.src)

    def take(self, idx) -> "Stream":
        return Stream(self.src[idx], self.dst[idx], self.ts[idx], self.eid[idx],
                      self.label[idx])


@dataclasses.dataclass
class Splits:
    node_feats: np.ndarray  # (N+1, 172) float32, row 0 zero
    edge_feats: np.ndarray  # (E+1, 172) float32, row 0 zero
    full: Stream
    train: Stream
    val: Stream
    test: Stream
    new_node_val: Stream
    new_node_test: Stream


def synthetic_bipartite(num_src, num_dst, num_edges, edge_feat_dim=FEAT_DIM, time_span=1.0e6,
                        label_rate=0.02, repeat_bias=0.8, node_feat_scale=0.0, seed=0):
    """(stream, edge_feats, node_feats): ids 1-based (0 = sentinel), dst ids
    after the src ids, a zero edge row 0, integer-valued times."""
    rng = np.random.default_rng(seed)
    user_w = rng.pareto(1.5, num_src) + 1.0
    item_w = rng.pareto(1.2, num_dst) + 1.0
    u = rng.choice(num_src, size=num_edges, p=user_w / user_w.sum())
    ts = np.sort(rng.integers(0, int(time_span), size=num_edges)).astype(np.float64)
    fresh = rng.choice(num_dst, size=num_edges, p=item_w / item_w.sum())
    repeat = rng.uniform(size=num_edges) < repeat_bias
    i = repeat_items(u, fresh, repeat)
    label = (rng.uniform(size=num_edges) < label_rate).astype(np.float64)
    edge_feats = rng.normal(size=(num_edges, edge_feat_dim))
    stream = Stream(src=(u + 1).astype(np.int64), dst=(i + num_src + 1).astype(np.int64), ts=ts,
                    eid=np.arange(1, num_edges + 1, dtype=np.int64), label=label)
    edge_feats = np.vstack([np.zeros((1, edge_feat_dim)), edge_feats])
    node_feats = node_feat_scale * rng.normal(size=(num_src + num_dst + 1, edge_feat_dim))
    node_feats[0] = 0.0
    return stream, edge_feats, node_feats


def synthetic_yearly(num_nodes, num_edges, num_steps, seats, activity_shape=1.5, weight_mean=10.0,
                     seed=0):
    """(stream, edge_feats, node_feats) of a non-bipartite stream at the
    times 0 .. num_steps - 1, ids 1-based (0 = sentinel). ``seats`` nodes
    hold a seat at step 0; at each later step as many newcomers replace
    seated nodes drawn at random as bring every node in by the last step.
    A step's edges, ``num_edges`` shared out evenly, are distinct
    unordered pairs of its seated nodes, each drawn with probability in
    proportion to the product of its two nodes' activities (Pareto of
    shape ``activity_shape`` plus 1), in random orientation and order.
    The edge feature is one column, a count: 1 + Poisson(weight_mean - 1);
    node features are zero."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(num_nodes)
    activity = rng.pareto(activity_shape, num_nodes) + 1.0
    came = np.round(seats + (num_nodes - seats) * np.arange(num_steps) / max(num_steps - 1, 1))
    came = came.astype(np.int64)
    per_step = np.diff(np.round(np.linspace(0, num_edges, num_steps + 1)).astype(np.int64))
    seated = order[:seats].copy()
    src, dst, ts = [], [], []
    for step in range(num_steps):
        if step:
            new = order[came[step - 1] : came[step]]
            out = rng.choice(seats, size=len(new), replace=False)
            seated[out] = new
        u, v = _distinct_pairs(rng, seated, activity[seated], int(per_step[step]))
        flip = rng.uniform(size=len(u)) < 0.5
        shuffle = rng.permutation(len(u))
        src.append(np.where(flip, v, u)[shuffle])
        dst.append(np.where(flip, u, v)[shuffle])
        ts.append(np.full(len(u), float(step)))
    src, dst, ts = (np.concatenate(a) for a in (src, dst, ts))
    stream = Stream(src=(src + 1).astype(np.int64), dst=(dst + 1).astype(np.int64), ts=ts,
                    eid=np.arange(1, num_edges + 1, dtype=np.int64),
                    label=np.zeros(num_edges, dtype=np.float64))
    weight = 1.0 + rng.poisson(weight_mean - 1.0, size=(num_edges, 1)).astype(np.float64)
    edge_feats = np.vstack([np.zeros((1, 1)), weight])
    return stream, edge_feats, np.zeros((num_nodes + 1, FEAT_DIM))


def _distinct_pairs(rng, nodes: np.ndarray, weight: np.ndarray, n: int):
    """n distinct unordered pairs of ``nodes`` (u < v by position), each
    drawn with probability in proportion to the product of its nodes'
    weights: draws in bulk, repeats and self-pairs dropped, first draws
    kept."""
    p = weight / weight.sum()
    m = len(nodes)
    keys = np.empty(0, dtype=np.int64)
    while len(keys) < n:
        a, b = rng.choice(m, size=(2, 2 * n), p=p)
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        keys = np.concatenate([keys, (lo * m + hi)[lo != hi]])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]
    keys = keys[:n]
    return nodes[keys // m], nodes[keys % m]


def repeat_items(u: np.ndarray, fresh: np.ndarray, repeat: np.ndarray) -> np.ndarray:
    """Each edge's item: a repeating edge of a user seen before takes the
    item of that user's last non-repeating edge (its first edge counts as
    one), every other edge its fresh draw. The generator's per-edge loop,
    vectorized: grouped by user, each edge points at the last setter."""
    n = len(u)
    order = np.argsort(u, kind="stable")
    us = u[order]
    first = np.ones(n, dtype=bool)
    first[1:] = us[1:] != us[:-1]
    setter = first | ~repeat[order]
    last = np.maximum.accumulate(np.where(setter, np.arange(n), -1))
    items = np.empty(n, dtype=np.int64)
    items[order] = fresh[order[last]]
    return items


def _pad(feats: np.ndarray) -> np.ndarray:
    if feats.shape[1] < FEAT_DIM:
        feats = np.concatenate([feats, np.zeros((feats.shape[0], FEAT_DIM - feats.shape[1]))], 1)
    return feats.astype(np.float32)


def split(full: Stream, edge_feats, node_feats, val_ratio=0.15, test_ratio=0.15) -> Splits:
    """DyGLib's link-prediction split: quantile times, and 10% of all nodes
    drawn with ``random.Random(2020)`` from the post-val nodes as new test
    nodes, whose edges leave train."""
    val_time, test_time = np.quantile(full.ts, [1.0 - val_ratio - test_ratio, 1.0 - test_ratio])
    rng = random.Random(2020)
    node_set = set(full.src) | set(full.dst)
    test_nodes = set(full.src[full.ts > val_time]) | set(full.dst[full.ts > val_time])
    new_test = set(rng.sample(sorted(test_nodes), int(0.1 * len(node_set))))
    observed = ~np.isin(full.src, list(new_test)) & ~np.isin(full.dst, list(new_test))
    train = full.take((full.ts <= val_time) & observed)
    new_nodes = node_set - (set(train.src) | set(train.dst))
    val_mask = (full.ts <= test_time) & (full.ts > val_time)
    test_mask = full.ts > test_time
    touches_new = np.isin(full.src, list(new_nodes)) | np.isin(full.dst, list(new_nodes))
    return Splits(_pad(node_feats), _pad(edge_feats), full, train, full.take(val_mask),
                  full.take(test_mask), full.take(val_mask & touches_new),
                  full.take(test_mask & touches_new))


GENERATORS = {"bipartite": synthetic_bipartite, "yearly": synthetic_yearly}


def make_splits(stream_cfg: dict, seed: int) -> Splits:
    """The configuration's stream (its ``stream`` entry: the generator's
    ``kind`` and its parameters), drawn from the run's seed."""
    params = dict(stream_cfg)
    make = GENERATORS[params.pop("kind")]
    return split(*make(**params, seed=sub_seed(seed, "stream", 63)))


def train_sweep_rows(n_train: int, batch_size: int, first_batch: int, num_batches: int):
    """Row indices of ``num_batches`` whole train batches from
    ``first_batch`` on, cycling through the split's whole batches."""
    whole = n_train // batch_size
    if whole < 1:
        raise ValueError(f"{n_train} train edges hold no batch of {batch_size}")
    batches = (first_batch + np.arange(num_batches)) % whole
    return (batches[:, None] * batch_size + np.arange(batch_size)[None, :]).reshape(-1)
