from .base import FeatureTables
from .dygformer import (
    DyGFormer,
    DyGFormerInputs,
    DyGFormerNet,
    EntryWindow,
    PreLNTransformerEncoder,
)

__all__ = [
    "FeatureTables",
    "DyGFormer",
    "DyGFormerInputs",
    "DyGFormerNet",
    "EntryWindow",
    "PreLNTransformerEncoder",
]
