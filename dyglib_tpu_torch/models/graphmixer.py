"""GraphMixer: an MLP-mixer link encoder and a time-gap node encoder.

Counterpart of ``dyglib_tpu/models/graphmixer.py`` (f32), with its
parameter names:

  * a frozen time encoder (``TimeEncoder(trainable=False)``);
  * the link encoder over the K recent neighbors: [edge features ||
    Phi(dt)], Phi zeroed on padded rows, projected to the edge width
    (``projection_layer``), ``num_layers`` ``MLPMixer`` blocks (token
    mixing over K with expansion 0.5, channel mixing with expansion 4.0,
    exact-erf GELU feed-forwards, pre-norm residuals), then the mean over
    all K rows, pads included, as in the reference;
  * the node encoder: the mean of the raw features of the node's last
    ``time_gap`` neighbors, divided once more by ``time_gap`` (the
    reference's softmax-then-mean), 0 for an empty window, plus the node's
    own features; ``output_layer`` maps [link || node] to the node width.

The node encoder has two modes, fixed by ``node_encoder_mode``: "prefix"
(the default "auto" under ``recent`` with a CSR that holds
``feat_prefix``) reads the window's feature sum as two rows of
``csr.feat_prefix``; "gather" gathers the (B, time_gap, Dn) features. The
two agree to ~1e-6, not bit for bit. GraphMixer is pair-independent: the
trainer embeds the triple where neg_src = src. No kernel runs here: the
JAX model reaches no Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.csr import TemporalCSR
from ..graph.sampler import check_strategy, sample_neighbors, window_bounds
from ..nn.modules import LN_EPS, TimeEncoder, dropout, linear
from .base import FeatureTables


class FeedForwardNet(nn.Module):
    """fc1 (x expansion) -> GELU (exact erf) -> dropout -> fc2 -> dropout."""

    def __init__(self, input_dim: int, expansion: float, p: float, gen: torch.Generator):
        super().__init__()
        hidden = int(expansion * input_dim)
        self.fc1 = linear(input_dim, hidden, gen)
        self.fc2 = linear(hidden, input_dim, gen)
        self.p = p

    def forward(self, x: torch.Tensor, dropout_gen: torch.Generator | None = None):
        p = self.p if self.training else 0.0
        h = dropout(F.gelu(self.fc1(x)), p, dropout_gen)
        return dropout(self.fc2(h), p, dropout_gen)


class MLPMixer(nn.Module):
    """Token mixing over the K axis, then channel mixing, each pre-norm with
    a residual."""

    def __init__(self, num_tokens: int, num_channels: int, token_expansion: float,
                 channel_expansion: float, p: float, gen: torch.Generator):
        super().__init__()
        self.token_norm = nn.LayerNorm(num_tokens, eps=LN_EPS)
        self.token_ff = FeedForwardNet(num_tokens, token_expansion, p, gen)
        self.channel_norm = nn.LayerNorm(num_channels, eps=LN_EPS)
        self.channel_ff = FeedForwardNet(num_channels, channel_expansion, p, gen)

    def forward(self, x: torch.Tensor, dropout_gen: torch.Generator | None = None):
        """x (B, K, C) -> (B, K, C)."""
        h = self.token_ff(self.token_norm(x.transpose(1, 2)), dropout_gen).transpose(1, 2)
        x = x + h
        return x + self.channel_ff(self.channel_norm(x), dropout_gen)


class GraphMixerInputs(NamedTuple):
    query_ts: torch.Tensor  # (B,) int32
    nbr_eids: torch.Tensor  # (B, K) int32
    nbr_ts: torch.Tensor  # (B, K) int32
    nbr_mask: torch.Tensor  # (B, K) bool
    node_ids: torch.Tensor  # (B,) int32
    # the node encoder's window, in one of two layouts:
    #   gather: tg_ids / tg_mask (B, time_gap), tg_sum / tg_cnt None;
    #   prefix: tg_sum (B, Dn) the window's feature sum and tg_cnt (B,) its
    #     size, read from csr.feat_prefix; tg_ids / tg_mask None
    tg_ids: torch.Tensor | None = None
    tg_mask: torch.Tensor | None = None
    tg_sum: torch.Tensor | None = None
    tg_cnt: torch.Tensor | None = None


class GraphMixerNet(nn.Module):
    def __init__(
        self,
        node_dim: int,
        edge_dim: int,
        gen: torch.Generator,
        time_feat_dim: int = 100,
        num_tokens: int = 20,
        num_layers: int = 2,
        token_dim_expansion_factor: float = 0.5,
        channel_dim_expansion_factor: float = 4.0,
        dropout: float = 0.1,
        time_gap: int = 2000,
    ):
        super().__init__()
        self.time_gap = time_gap
        self.num_layers = num_layers
        self.time_encoder = TimeEncoder(time_feat_dim, trainable=False)
        self.projection_layer = linear(edge_dim + time_feat_dim, edge_dim, gen)
        for i in range(num_layers):
            self.add_module(f"mlp_mixer_{i}", MLPMixer(
                num_tokens, edge_dim, token_dim_expansion_factor, channel_dim_expansion_factor,
                dropout, gen))
        self.output_layer = linear(edge_dim + node_dim, node_dim, gen)

    def forward(
        self,
        tables: FeatureTables,
        inputs: GraphMixerInputs,
        *,
        dropout_gen: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Embeddings (B, Dn) of the queries. In train mode with dropout > 0,
        ``dropout_gen`` draws the masks."""
        # ---- link encoder
        edge_feats = tables.edge[inputs.nbr_eids.long()]
        dt = (inputs.query_ts[:, None] - inputs.nbr_ts).to(torch.float32)
        time_feats = torch.where(inputs.nbr_mask[..., None], self.time_encoder(dt), 0.0)
        x = self.projection_layer(torch.cat([edge_feats, time_feats], dim=-1))
        for i in range(self.num_layers):
            x = getattr(self, f"mlp_mixer_{i}")(x, dropout_gen)
        link_feat = x.mean(dim=1)  # over all K rows, pads included

        # ---- node encoder: the window's mean feature / time_gap
        if inputs.tg_sum is not None:
            cnt = inputs.tg_cnt.to(torch.float32)
            agg = inputs.tg_sum / cnt.clamp_min(1.0)[:, None] / float(self.time_gap)
            agg = torch.where((cnt > 0)[:, None], agg, 0.0)
        else:
            m = inputs.tg_mask[..., None].to(torch.float32)
            n_valid = m.sum(dim=1).clamp_min(1.0)
            agg = (tables.node[inputs.tg_ids.long()] * m).sum(dim=1) / n_valid / float(
                self.time_gap)
            agg = torch.where(inputs.tg_mask.any(dim=1)[:, None], agg, 0.0)
        node_feat = agg + tables.node[inputs.node_ids.long()]
        return self.output_layer(torch.cat([link_feat, node_feat], dim=-1))


@dataclasses.dataclass
class GraphMixer:
    """Backbone adapter: sampling and the net's construction."""

    num_neighbors: int = 20  # the mixer's tokens
    num_layers: int = 2
    time_feat_dim: int = 100
    token_dim_expansion_factor: float = 0.5
    channel_dim_expansion_factor: float = 4.0
    dropout: float = 0.1
    time_gap: int = 2000
    sample_strategy: str = "recent"
    # "prefix" reads the node encoder's window sums from csr.feat_prefix
    # (recent only), "gather" gathers the window's rows, "auto" takes the
    # prefix where the CSR holds it
    node_encoder_mode: str = "auto"
    # embeddings depend only on (node, time): the trainer embeds the triple
    # [src, dst, neg_dst] where neg_src = src
    pair_independent: ClassVar[bool] = True

    def __post_init__(self):
        check_strategy(self.sample_strategy)
        if self.node_encoder_mode not in ("auto", "prefix", "gather"):
            raise ValueError(f"unknown node_encoder_mode {self.node_encoder_mode!r}")

    @property
    def wants_feat_prefix(self) -> bool:
        """Ask the trainer to build csr.feat_prefix."""
        return self.node_encoder_mode in ("auto", "prefix") and self.sample_strategy == "recent"

    def build(self, node_dim: int, edge_dim: int, gen: torch.Generator) -> GraphMixerNet:
        """A GraphMixerNet whose parameters are drawn from ``gen`` (on the CPU)."""
        return GraphMixerNet(
            node_dim, edge_dim, gen,
            time_feat_dim=self.time_feat_dim,
            num_tokens=self.num_neighbors,
            num_layers=self.num_layers,
            token_dim_expansion_factor=self.token_dim_expansion_factor,
            channel_dim_expansion_factor=self.channel_dim_expansion_factor,
            dropout=self.dropout,
            time_gap=self.time_gap,
        )

    def sample(
        self, csr: TemporalCSR, ids: torch.Tensor, ts: torch.Tensor,
        gen: torch.Generator | None = None,
    ) -> GraphMixerInputs:
        """The K neighbors of queries (ids, ts) and their node encoder's
        window; the stochastic strategies draw from ``gen``."""
        ids, ts = ids.to(torch.int32), ts.to(torch.int32)
        blk = sample_neighbors(csr, ids, ts, self.num_neighbors, self.sample_strategy, gen)
        common = dict(query_ts=ts, nbr_eids=blk.eid, nbr_ts=blk.ts, nbr_mask=blk.mask,
                      node_ids=ids)
        if self.wants_feat_prefix and csr.feat_prefix is not None:
            # the recent time_gap window is the contiguous CSR range
            # [max(lo, hi - time_gap), hi): its sum is two prefix rows
            lo, hi = window_bounds(csr, ids, ts)
            lo2 = torch.maximum(lo, hi - self.time_gap)
            cnt = hi - lo2
            top = csr.feat_prefix[(hi - 1).clamp_min(0).long()]
            bot = torch.where((lo2 > lo)[:, None],
                              csr.feat_prefix[(lo2 - 1).clamp_min(0).long()], 0.0)
            tg_sum = torch.where((cnt > 0)[:, None], top - bot, 0.0)
            return GraphMixerInputs(**common, tg_sum=tg_sum, tg_cnt=cnt)
        if self.node_encoder_mode == "prefix":
            raise ValueError("node_encoder_mode='prefix' needs a CSR built with "
                             "feat_prefix_of=node features and the 'recent' strategy")
        tg = sample_neighbors(csr, ids, ts, self.time_gap, self.sample_strategy, gen)
        return GraphMixerInputs(**common, tg_ids=tg.nbr, tg_mask=tg.mask)
