from .csr import TemporalCSR, build_temporal_csr, time_keys
from .neg_sampler import NegativeEdgeSampler
from .sampler import window_bounds

__all__ = [
    "TemporalCSR",
    "build_temporal_csr",
    "time_keys",
    "NegativeEdgeSampler",
    "window_bounds",
]
