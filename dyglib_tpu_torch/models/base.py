"""Raw feature tables shared by every model.

Counterpart of ``dyglib_tpu/models/base.py::FeatureTables``.
"""
from __future__ import annotations

import dataclasses

import torch


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
