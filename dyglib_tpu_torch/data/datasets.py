"""Dataset loading and chronological train/val/test splitting.

Counterpart of ``dyglib_tpu/data/datasets.py``, read without pandas: the
processed ``ml_<name>.csv`` edge list is parsed with numpy, columns found
by their header names.

Link-prediction split protocol (identical to the JAX package):
  * features are zero-padded to 172 dims (asserted <= 172);
  * val/test boundary times are the (1 - val - test) / (1 - test) quantiles
    of the timestamp column;
  * inductive protocol: with ``random.Random(2020)``, 10% of ALL nodes are
    sampled from the sorted post-val-time node set as "new nodes" and every
    edge touching one is removed from train; new_node_val/test hold the
    val/test edges touching at least one node absent from the train set.

Node-classification split: the same features and quantile boundaries, a
plain chronological 3-way split with no new-node logic.
"""
from __future__ import annotations

import csv
import dataclasses
import os
import random

import numpy as np

from .containers import EdgeStream

FEAT_DIM = 172  # all node/edge features are zero-padded to 172 columns


@dataclasses.dataclass
class LinkPredictionData:
    node_raw_features: np.ndarray  # (N+1, 172) float32, row 0 = sentinel
    edge_raw_features: np.ndarray  # (E+1, 172) float32, row 0 = sentinel
    full: EdgeStream
    train: EdgeStream
    val: EdgeStream
    test: EdgeStream
    new_node_val: EdgeStream
    new_node_test: EdgeStream

    @property
    def num_nodes(self) -> int:
        """Number of node-id slots including the 0 sentinel."""
        return self.node_raw_features.shape[0]


@dataclasses.dataclass
class NodeClassificationData:
    node_raw_features: np.ndarray  # (N+1, 172) float32, row 0 = sentinel
    edge_raw_features: np.ndarray  # (E+1, 172) float32, row 0 = sentinel
    full: EdgeStream
    train: EdgeStream
    val: EdgeStream
    test: EdgeStream

    @property
    def num_nodes(self) -> int:
        return self.node_raw_features.shape[0]


def _pad_features(feats: np.ndarray, dim: int = FEAT_DIM) -> np.ndarray:
    """Zero-pad feature columns to ``dim``."""
    if feats.shape[1] > dim:
        raise ValueError(f"feature dimension {feats.shape[1]} is bigger than {dim}")
    if feats.shape[1] < dim:
        pad = np.zeros((feats.shape[0], dim - feats.shape[1]))
        feats = np.concatenate([feats, pad], axis=1)
    return feats


def read_edge_csv(path: str) -> EdgeStream:
    """Parse a processed ``ml_<name>.csv`` (columns u, i, ts, label, idx)."""
    with open(path, newline="") as f:
        header = next(csv.reader(f))
    col = {name: k for k, name in enumerate(header)}
    table = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64, ndmin=2)
    return EdgeStream(
        src=table[:, col["u"]].astype(np.int64),
        dst=table[:, col["i"]].astype(np.int64),
        ts=table[:, col["ts"]].astype(np.float64),
        eid=table[:, col["idx"]].astype(np.int64),
        label=table[:, col["label"]].astype(np.float64),
    )


def split_link_prediction_data(
    full: EdgeStream,
    edge_feats: np.ndarray,
    node_feats: np.ndarray,
    val_ratio: float = 0.15,
    test_ratio: float = 0.15,
) -> LinkPredictionData:
    """Pad features and split a full stream for transductive and inductive
    link prediction."""
    node_feats = _pad_features(node_feats).astype(np.float32)
    edge_feats = _pad_features(edge_feats).astype(np.float32)
    val_time, test_time = np.quantile(
        full.ts, [1.0 - val_ratio - test_ratio, 1.0 - test_ratio]
    )

    rng = random.Random(2020)  # protocol seed
    node_set = set(full.src) | set(full.dst)
    num_total_unique_node_ids = len(node_set)
    test_node_set = set(full.src[full.ts > val_time]) | set(full.dst[full.ts > val_time])
    new_test_node_set = set(
        rng.sample(sorted(test_node_set), int(0.1 * num_total_unique_node_ids))
    )

    new_test_src_mask = np.isin(full.src, list(new_test_node_set))
    new_test_dst_mask = np.isin(full.dst, list(new_test_node_set))
    observed_edges_mask = ~new_test_src_mask & ~new_test_dst_mask

    train = full.mask((full.ts <= val_time) & observed_edges_mask)
    train_node_set = set(train.src) | set(train.dst)
    if train_node_set & new_test_node_set:
        raise AssertionError("new test nodes leaked into the train split")
    new_node_set = node_set - train_node_set

    val_mask = (full.ts <= test_time) & (full.ts > val_time)
    test_mask = full.ts > test_time
    edge_contains_new_node = np.isin(full.src, list(new_node_set)) | np.isin(
        full.dst, list(new_node_set)
    )
    return LinkPredictionData(
        node_raw_features=node_feats,
        edge_raw_features=edge_feats,
        full=full,
        train=train,
        val=full.mask(val_mask),
        test=full.mask(test_mask),
        new_node_val=full.mask(val_mask & edge_contains_new_node),
        new_node_test=full.mask(test_mask & edge_contains_new_node),
    )


def split_node_classification_data(
    full: EdgeStream,
    edge_feats: np.ndarray,
    node_feats: np.ndarray,
    val_ratio: float = 0.15,
    test_ratio: float = 0.15,
) -> NodeClassificationData:
    """Pad features and split a full stream chronologically at the
    (1 - val - test) and (1 - test) time quantiles."""
    val_time, test_time = np.quantile(full.ts, [1.0 - val_ratio - test_ratio, 1.0 - test_ratio])
    return NodeClassificationData(
        node_raw_features=_pad_features(node_feats).astype(np.float32),
        edge_raw_features=_pad_features(edge_feats).astype(np.float32),
        full=full,
        train=full.mask(full.ts <= val_time),
        val=full.mask((full.ts <= test_time) & (full.ts > val_time)),
        test=full.mask(full.ts > test_time),
    )


def _load_processed(dataset_name: str, data_root: str):
    """(full stream, edge features, node features) of
    ``data_root/<name>/ml_<name>{.csv,.npy,_node.npy}``."""
    d = os.path.join(data_root, dataset_name)
    return (read_edge_csv(os.path.join(d, f"ml_{dataset_name}.csv")),
            np.load(os.path.join(d, f"ml_{dataset_name}.npy")),
            np.load(os.path.join(d, f"ml_{dataset_name}_node.npy")))


def get_link_prediction_data(
    dataset_name: str,
    val_ratio: float = 0.15,
    test_ratio: float = 0.15,
    data_root: str = "./processed_data",
) -> LinkPredictionData:
    """Load a processed dataset and split it for link prediction."""
    return split_link_prediction_data(
        *_load_processed(dataset_name, data_root), val_ratio, test_ratio)


def get_node_classification_data(
    dataset_name: str,
    val_ratio: float = 0.15,
    test_ratio: float = 0.15,
    data_root: str = "./processed_data",
) -> NodeClassificationData:
    """Load a processed dataset and split it for node classification."""
    return split_node_classification_data(
        *_load_processed(dataset_name, data_root), val_ratio, test_ratio)
