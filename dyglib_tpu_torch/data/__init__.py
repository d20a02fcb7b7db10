from .batching import Batch, chronological_batches
from .containers import EdgeStream
from .datasets import (
    FEAT_DIM,
    LinkPredictionData,
    get_link_prediction_data,
    read_edge_csv,
    split_link_prediction_data,
)
from .synthetic import make_synthetic_bipartite, synthetic_link_prediction_data

__all__ = [
    "Batch",
    "chronological_batches",
    "EdgeStream",
    "FEAT_DIM",
    "LinkPredictionData",
    "get_link_prediction_data",
    "read_edge_csv",
    "split_link_prediction_data",
    "make_synthetic_bipartite",
    "synthetic_link_prediction_data",
]
