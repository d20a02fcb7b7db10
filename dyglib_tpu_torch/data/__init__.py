from .batching import Batch, chronological_batches
from .containers import EdgeStream
from .datasets import (
    FEAT_DIM,
    LinkPredictionData,
    NodeClassificationData,
    get_link_prediction_data,
    get_node_classification_data,
    read_edge_csv,
    split_link_prediction_data,
    split_node_classification_data,
)
from .preprocess import DATASET_NAMES, write_processed
from .synthetic import (
    make_synthetic_bipartite,
    synthetic_link_prediction_data,
    write_synthetic_dataset,
)

__all__ = [
    "Batch",
    "chronological_batches",
    "EdgeStream",
    "FEAT_DIM",
    "LinkPredictionData",
    "NodeClassificationData",
    "get_link_prediction_data",
    "get_node_classification_data",
    "read_edge_csv",
    "split_link_prediction_data",
    "split_node_classification_data",
    "DATASET_NAMES",
    "write_processed",
    "make_synthetic_bipartite",
    "synthetic_link_prediction_data",
    "write_synthetic_dataset",
]
