from .checkpoints import load_checkpoint, save_checkpoint
from .early_stopping import EarlyStopping
from .link_prediction import LinkPredictionTrainer, TrainConfig, make_optimizer
from .metrics import average_precision, link_prediction_metrics, roc_auc

__all__ = [
    "load_checkpoint",
    "save_checkpoint",
    "EarlyStopping",
    "LinkPredictionTrainer",
    "TrainConfig",
    "make_optimizer",
    "average_precision",
    "link_prediction_metrics",
    "roc_auc",
]
