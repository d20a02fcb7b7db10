from .base import FeatureTables
from .dygformer import (
    DyGFormer,
    DyGFormerInputs,
    DyGFormerNet,
    EntryWindow,
    PreLNTransformerEncoder,
)
from .tgat import TGAT, TGATInputs, TGATNet

__all__ = [
    "FeatureTables",
    "DyGFormer",
    "DyGFormerInputs",
    "DyGFormerNet",
    "EntryWindow",
    "PreLNTransformerEncoder",
    "TGAT",
    "TGATInputs",
    "TGATNet",
]
