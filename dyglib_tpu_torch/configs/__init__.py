from .args import MODEL_NAMES, get_link_prediction_args, get_node_classification_args
from .best_configs import (
    load_link_prediction_best_configs,
    load_node_classification_best_configs,
)
from .factory import build_backbone

__all__ = [
    "MODEL_NAMES",
    "get_link_prediction_args",
    "get_node_classification_args",
    "load_link_prediction_best_configs",
    "load_node_classification_best_configs",
    "build_backbone",
]
