"""Raw feature tables shared by every model, and the compute dtypes.

Counterpart of ``dyglib_tpu/models/base.py::FeatureTables``.
"""
from __future__ import annotations

import dataclasses

import torch

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a model's ``compute_dtype`` field."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r} is not one of {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


@dataclasses.dataclass
class FeatureTables:
    """Raw feature tables on one device (row 0 = padding sentinel)."""

    node: torch.Tensor  # (N, 172) float32
    edge: torch.Tensor  # (E+1, 172) float32

    @property
    def node_dim(self) -> int:
        return self.node.shape[1]

    @property
    def edge_dim(self) -> int:
        return self.edge.shape[1]
