from .csr import TemporalCSR, build_temporal_csr, time_keys
from .neg_sampler import NegativeEdgeSampler, build_eval_neg_samplers
from .sampler import (
    NeighborBlock,
    fetch_entry_windows,
    sample_multi_hop,
    sample_neighbors,
    sample_recent,
    sample_time_interval_aware,
    sample_uniform,
    tia_select,
    window_bounds,
)

__all__ = [
    "TemporalCSR",
    "build_temporal_csr",
    "time_keys",
    "NegativeEdgeSampler",
    "build_eval_neg_samplers",
    "NeighborBlock",
    "fetch_entry_windows",
    "sample_multi_hop",
    "sample_neighbors",
    "sample_recent",
    "sample_time_interval_aware",
    "sample_uniform",
    "tia_select",
    "window_bounds",
]
