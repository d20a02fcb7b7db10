from .modules import (
    LN_EPS,
    MergeLayer,
    TemporalMultiHeadAttention,
    TimeEncoder,
    dropout,
    linear,
    time_encoder_spectrum,
)

__all__ = [
    "LN_EPS",
    "MergeLayer",
    "TemporalMultiHeadAttention",
    "TimeEncoder",
    "dropout",
    "linear",
    "time_encoder_spectrum",
]
