"""TCL: a transformer over [target + K recent neighbors] with src <-> dst
cross-attention.

Counterpart of ``dyglib_tpu/models/tcl.py`` (f32), with its parameter
names:

  * each row's sequence is its target node (edge id 0, time = the
    interaction time) followed by its K sampled neighbors;
  * features = proj_node(node) + proj_edge(edge) + proj_time(Phi(dt)) +
    a learned depth embedding per position (N(0, 1) init, as torch's
    ``nn.Embedding``);
  * per layer, one post-LN ``TransformerEncoder`` applied four times:
    self-attention on each side, then each side's cross-attention against
    the other side's self-attended features, masked by the other side's
    padding;
  * output = ``output_layer`` of each sequence's first token.

TCL is paired: ``triple=True`` pairs the triple [src || dst || neg_dst]
as (src, dst) and (src, neg_dst), src's rows computed once (exact where
neg_src = src and the draws are the same: ``recent``); otherwise the quad
[src || dst || neg_src || neg_dst] is paired as (src, dst) and (neg_src,
neg_dst). Either returns quad-order embeddings. No kernel runs here: the
JAX model reaches no Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import torch
from torch import nn

from ..graph.csr import TemporalCSR
from ..graph.sampler import check_strategy, sample_neighbors
from ..nn.modules import TimeEncoder, TransformerEncoder, linear
from .base import FeatureTables


class TCLInputs(NamedTuple):
    seq_ids: torch.Tensor  # (M, K+1) int32, the target first
    seq_eids: torch.Tensor  # (M, K+1) int32
    seq_ts: torch.Tensor  # (M, K+1) int32
    query_ts: torch.Tensor  # (M,) int32


class TCLNet(nn.Module):
    def __init__(
        self,
        node_dim: int,
        edge_dim: int,
        gen: torch.Generator,
        time_feat_dim: int = 100,
        num_layers: int = 2,
        num_heads: int = 2,
        num_depths: int = 21,
        dropout: float = 0.1,
    ):
        super().__init__()
        d = node_dim
        self.num_layers = num_layers
        self.time_encoder = TimeEncoder(time_feat_dim)
        self.depth_embedding = nn.Embedding(num_depths, d)
        with torch.no_grad():
            self.depth_embedding.weight.copy_(torch.randn((num_depths, d), generator=gen))
        self.proj_node = linear(node_dim, d, gen)
        self.proj_edge = linear(edge_dim, d, gen)
        self.proj_time = linear(time_feat_dim, d, gen)
        for i in range(num_layers):
            self.add_module(f"transformer_{i}", TransformerEncoder(d, num_heads, dropout, gen))
        self.output_layer = linear(d, d, gen)

    def forward(
        self,
        tables: FeatureTables,
        inputs: TCLInputs,
        *,
        triple: bool = False,
        dropout_gen: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Quad-order embeddings (4B, Dn) of the triple (``triple=True``) or
        the quad. In train mode with dropout > 0, ``dropout_gen`` draws the
        masks."""
        seq_ids = inputs.seq_ids
        dev = seq_ids.device
        dt = (inputs.query_ts[:, None] - inputs.seq_ts).to(torch.float32)
        depth = self.depth_embedding(torch.arange(seq_ids.shape[1], device=dev))
        feats = (self.proj_node(tables.node[seq_ids.long()])
                 + self.proj_edge(tables.edge[inputs.seq_eids.long()])
                 + self.proj_time(self.time_encoder(dt)) + depth)
        masks = seq_ids != 0

        m = seq_ids.shape[0]
        ar = lambda a, z: torch.arange(a, z, device=dev)
        if triple:
            b = m // 3
            left, right = torch.cat([ar(0, b), ar(0, b)]), ar(b, 3 * b)
        else:
            b = m // 4
            left = torch.cat([ar(0, b), ar(2 * b, 3 * b)])
            right = torch.cat([ar(b, 2 * b), ar(3 * b, 4 * b)])
        lf, rf, lm, rm = feats[left], feats[right], masks[left], masks[right]
        for i in range(self.num_layers):
            layer = getattr(self, f"transformer_{i}")
            lf_sa = layer(lf, lf, lf, lm, dropout_gen)
            rf_sa = layer(rf, rf, rf, rm, dropout_gen)
            lf, rf = (layer(lf_sa, rf_sa, rf_sa, rm, dropout_gen),
                      layer(rf_sa, lf_sa, lf_sa, lm, dropout_gen))
        out_l, out_r = self.output_layer(lf[:, 0]), self.output_layer(rf[:, 0])
        return torch.cat([out_l[:b], out_r[:b], out_l[b:], out_r[b:]], dim=0)


@dataclasses.dataclass
class TCL:
    """Backbone adapter: sampling and the net's construction (paired)."""

    num_neighbors: int = 20
    num_layers: int = 2
    num_heads: int = 2
    dropout: float = 0.1
    time_feat_dim: int = 100
    sample_strategy: str = "recent"
    # cross-attention pairs src with dst: embeddings depend on the partner
    pair_independent: ClassVar[bool] = False
    # where neg_src = src under recent the net pairs the triple itself
    triple_expand: ClassVar[bool] = True

    def __post_init__(self):
        check_strategy(self.sample_strategy)

    def build(self, node_dim: int, edge_dim: int, gen: torch.Generator) -> TCLNet:
        """A TCLNet whose parameters are drawn from ``gen`` (on the CPU)."""
        return TCLNet(
            node_dim, edge_dim, gen,
            time_feat_dim=self.time_feat_dim,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            num_depths=self.num_neighbors + 1,
            dropout=self.dropout,
        )

    def sample(
        self, csr: TemporalCSR, ids: torch.Tensor, ts: torch.Tensor,
        gen: torch.Generator | None = None,
    ) -> TCLInputs:
        """Each query's sequence: itself, then its K sampled neighbors; the
        stochastic strategies draw from ``gen``."""
        ids, ts = ids.to(torch.int32), ts.to(torch.int32)
        blk = sample_neighbors(csr, ids, ts, self.num_neighbors, self.sample_strategy, gen)
        zeros = torch.zeros_like(ids)[:, None]
        return TCLInputs(
            seq_ids=torch.cat([ids[:, None], blk.nbr], dim=1),
            seq_eids=torch.cat([zeros, blk.eid], dim=1),
            seq_ts=torch.cat([ts[:, None], blk.ts], dim=1),
            query_ts=ts,
        )
