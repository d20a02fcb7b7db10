from .checkpoints import load_checkpoint, save_checkpoint, to_device
from .early_stopping import EarlyStopping
from .edgebank_eval import evaluate_edge_bank_link_prediction
from .link_prediction import LinkPredictionTrainer, TrainConfig, make_optimizer
from .metrics import (
    average_precision,
    link_prediction_metrics,
    node_classification_metrics,
    roc_auc,
)
from .node_classification import NodeClassificationTrainer

__all__ = [
    "load_checkpoint",
    "save_checkpoint",
    "to_device",
    "EarlyStopping",
    "evaluate_edge_bank_link_prediction",
    "LinkPredictionTrainer",
    "TrainConfig",
    "make_optimizer",
    "NodeClassificationTrainer",
    "average_precision",
    "link_prediction_metrics",
    "node_classification_metrics",
    "roc_auc",
]
