"""Synthetic bipartite CTDG generator, in memory.

Counterpart of ``dyglib_tpu/data/synthetic.py``: the same
``np.random.default_rng(seed)`` draws in the same order, so one seed gives
the same stream in both packages. ``synthetic_link_prediction_data``
builds the split dataset without touching files.
"""
from __future__ import annotations

import numpy as np

from .containers import EdgeStream
from .datasets import LinkPredictionData, split_link_prediction_data


def make_synthetic_bipartite(
    num_src: int = 500,
    num_dst: int = 200,
    num_edges: int = 5000,
    edge_feat_dim: int = 172,
    time_span: float = 1.0e6,
    label_rate: float = 0.02,
    repeat_bias: float = 0.8,
    node_feat_scale: float = 0.0,
    seed: int = 0,
) -> tuple[EdgeStream, np.ndarray, np.ndarray]:
    """(stream, edge_feats, node_feats) in the processed layout: ids 1-based
    (0 = sentinel), dst ids offset past src ids, edge features with a zero
    row 0, integer-valued timestamps."""
    rng = np.random.default_rng(seed)

    user_w = rng.pareto(1.5, num_src) + 1.0
    item_w = rng.pareto(1.2, num_dst) + 1.0
    u = rng.choice(num_src, size=num_edges, p=user_w / user_w.sum())
    ts = np.sort(rng.integers(0, int(time_span), size=num_edges)).astype(np.float64)

    i = np.empty(num_edges, dtype=np.int64)
    last_item: dict[int, int] = {}
    fresh = rng.choice(num_dst, size=num_edges, p=item_w / item_w.sum())
    repeat = rng.uniform(size=num_edges) < repeat_bias
    for k in range(num_edges):
        uk = int(u[k])
        if repeat[k] and uk in last_item:
            i[k] = last_item[uk]
        else:
            i[k] = fresh[k]
            last_item[uk] = int(i[k])

    label = (rng.uniform(size=num_edges) < label_rate).astype(np.float64)
    edge_feats = rng.normal(size=(num_edges, edge_feat_dim))

    stream = EdgeStream(
        src=(u + 1).astype(np.int64),
        dst=(i + num_src + 1).astype(np.int64),
        ts=ts,
        eid=np.arange(1, num_edges + 1, dtype=np.int64),
        label=label,
    )
    edge_feats = np.vstack([np.zeros((1, edge_feat_dim)), edge_feats])
    node_feats = node_feat_scale * rng.normal(size=(num_src + num_dst + 1, edge_feat_dim))
    node_feats[0] = 0.0
    return stream, edge_feats, node_feats


def synthetic_link_prediction_data(
    val_ratio: float = 0.15, test_ratio: float = 0.15, **kwargs
) -> LinkPredictionData:
    """The split dataset of ``make_synthetic_bipartite(**kwargs)``, in memory."""
    stream, edge_feats, node_feats = make_synthetic_bipartite(**kwargs)
    return split_link_prediction_data(stream, edge_feats, node_feats, val_ratio, test_ratio)
