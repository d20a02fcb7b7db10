from .checkpoints import load_checkpoint
from .link_prediction import LinkPredictionTrainer, TrainConfig
from .metrics import average_precision, link_prediction_metrics, roc_auc

__all__ = [
    "load_checkpoint",
    "LinkPredictionTrainer",
    "TrainConfig",
    "average_precision",
    "link_prediction_metrics",
    "roc_auc",
]
