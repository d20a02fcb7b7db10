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
from .preprocess import (
    BIPARTITE_DATASETS,
    DATASET_NAMES,
    check_processed,
    parse_raw_csv,
    preprocess_dataset,
    reindex,
    write_processed,
)
from .statistics import dataset_statistics
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
    "BIPARTITE_DATASETS",
    "DATASET_NAMES",
    "check_processed",
    "parse_raw_csv",
    "preprocess_dataset",
    "reindex",
    "write_processed",
    "dataset_statistics",
    "make_synthetic_bipartite",
    "synthetic_link_prediction_data",
    "write_synthetic_dataset",
]
