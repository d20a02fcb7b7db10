from .modules import (
    LN_EPS,
    FusedGRUCell,
    FusedRNNCell,
    MergeLayer,
    MLPClassifier,
    TemporalMultiHeadAttention,
    TimeEncoder,
    TransformerEncoder,
    dropout,
    linear,
    time_encoder_spectrum,
)

__all__ = [
    "LN_EPS",
    "FusedGRUCell",
    "FusedRNNCell",
    "MergeLayer",
    "MLPClassifier",
    "TemporalMultiHeadAttention",
    "TimeEncoder",
    "TransformerEncoder",
    "dropout",
    "linear",
    "time_encoder_spectrum",
]
