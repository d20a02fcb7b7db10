from .base import FeatureTables
from .dygformer import DyGFormer, DyGFormerInputs, DyGFormerNet, PreLNTransformerEncoder

__all__ = [
    "FeatureTables",
    "DyGFormer",
    "DyGFormerInputs",
    "DyGFormerNet",
    "PreLNTransformerEncoder",
]
