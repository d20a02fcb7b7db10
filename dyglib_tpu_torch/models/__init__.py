from .base import FeatureTables
from .dygformer import (
    DyGFormer,
    DyGFormerInputs,
    DyGFormerNet,
    EntryWindow,
    PreLNTransformerEncoder,
)
from .memory_model import (
    MemoryModel,
    MemoryModelInputs,
    MemoryModelNet,
    MemoryState,
    TimeShiftStats,
    compute_src_dst_node_time_shifts,
    memory_order_violations,
    quad_roles,
    segment_roles,
)
from .tgat import TGAT, TGATInputs, TGATNet

__all__ = [
    "FeatureTables",
    "DyGFormer",
    "DyGFormerInputs",
    "DyGFormerNet",
    "EntryWindow",
    "PreLNTransformerEncoder",
    "MemoryModel",
    "MemoryModelInputs",
    "MemoryModelNet",
    "MemoryState",
    "TimeShiftStats",
    "compute_src_dst_node_time_shifts",
    "memory_order_violations",
    "quad_roles",
    "segment_roles",
    "TGAT",
    "TGATInputs",
    "TGATNet",
]
