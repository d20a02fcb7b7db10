from .modules import LN_EPS, MergeLayer, TimeEncoder, linear, time_encoder_spectrum

__all__ = [
    "LN_EPS",
    "MergeLayer",
    "TimeEncoder",
    "linear",
    "time_encoder_spectrum",
]
