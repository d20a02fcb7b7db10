from .csr import TemporalCSR, build_temporal_csr, time_keys
from .neg_sampler import NegativeEdgeSampler
from .sampler import (
    NeighborBlock,
    fetch_entry_windows,
    sample_multi_hop,
    sample_recent,
    sample_uniform,
    window_bounds,
)

__all__ = [
    "TemporalCSR",
    "build_temporal_csr",
    "time_keys",
    "NegativeEdgeSampler",
    "NeighborBlock",
    "fetch_entry_windows",
    "sample_multi_hop",
    "sample_recent",
    "sample_uniform",
    "window_bounds",
]
