"""CAWN: causal anonymous walk network.

Counterpart of ``dyglib_tpu/models/cawn.py`` (f32 or bf16 compute), with
its parameter names:

  * ``sample`` builds the hop tables of each row's walk tree from
    ``sample_multi_hop`` (``time_interval_aware`` by default): hop st holds
    K**st (node, edge, time) entries, hop 0 the target (edge id 0); walk w
    is [target, hop 1, ..., hop L] along the repeat alignment (walk step
    st is hop entry w // K**(L-st));
  * position features: for each hop entry, (occurrences of its node at hop
    h of the src-rooted and of the dst-rooted tree) / K**h, pad node 0
    zeroed (``hop_position_counts``: a fused compare between hop tables,
    or a sorted-key join for trees too large to compare); then
    ``position_fc2(relu(position_fc1(counts)))`` summed over the two roots;
  * walk steps [node || Phi(dt) || edge || position] through a BiLSTM read
    at each walk's last valid step (``TreeBiLSTMEncoder``, evaluated on the
    hop tree), and the position features through a second one;
    ``projection_0`` to the attention width (half the input width, rounded
    up to the heads), the post-LN ``walk_transformer`` over the walks, the
    mean over walks and ``projection_1``.

CAWN is pair-aware through its position counts, which pair quad row q
with q + B (left rows) or q - B (right rows): the trainer always gives it
the quad [src || dst || neg_src || neg_dst]. ``compute_dtype`` "auto" is
float32: the JAX package's bfloat16 on the TPU is a TPU measurement that
does not carry over. ``compute_dtype="bfloat16"`` rounds as the JAX model
does: the position MLP, the walk-step features, both BiLSTMs (inputs,
weights, the recurrent h and c), ``projection_0`` and the walk
transformer's products in bf16; the encoders' outputs, the transformer's
residual stream and ``projection_1`` in f32. No kernel runs here: the JAX
model reaches no Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import torch
from torch import nn

from ..graph.csr import TemporalCSR
from ..graph.sampler import check_strategy, sample_multi_hop
from ..nn.modules import TimeEncoder, TransformerEncoder, _uniform, linear, project, sigmoid
from .base import FeatureTables, compute_dtype_of

# the fused compare holds m * biggest**2 booleans; above this, the join
FUSED_COUNT_LIMIT = 1 << 28


class CAWNInputs(NamedTuple):
    walk_ids: torch.Tensor  # (M, W, L+1) int32
    query_ts: torch.Tensor  # (M,) int32
    hop_ids: tuple  # st = 0..L: (M, K**st) int32 node ids
    hop_eids: tuple  # st = 0..L: (M, K**st) int32 edge ids (0 at st = 0)
    hop_ts: tuple  # st = 0..L: (M, K**st) int32 time keys


def expand_to_walks(arr: torch.Tensor, w: int) -> torch.Tensor:
    """(M, K**st, ...) hop values -> (M, W, ...) along the walks' repeat
    alignment."""
    return torch.repeat_interleave(arr, w // arr.shape[1], dim=1)


def _quad_partner(m: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Each quad row's partner (q + B for left rows, q - B for right rows)
    and whether it is a left row, (M, 1)."""
    b = m // 4
    ar = torch.arange(b, device=device)
    partner = torch.cat([ar + b, ar, ar + 3 * b, ar + 2 * b])
    is_left = torch.cat([torch.ones(b, dtype=torch.bool, device=device),
                         torch.zeros(b, dtype=torch.bool, device=device)] * 2)
    return partner, is_left[:, None]


def hop_position_counts(hop_ids: tuple, num_nodes: int) -> tuple:
    """Per hop table st, (M, K**st, 2, L+1) counts: cell [..., s, h] = the
    occurrences of the entry's node at hop h of side s's tree (s = 0 the
    src-rooted one) / K**h; pad entries zeroed. The fused compare where
    m * biggest**2 <= FUSED_COUNT_LIMIT, else the sorted-key join."""
    m, lp1 = hop_ids[0].shape[0], len(hop_ids)
    biggest = max(h.shape[1] for h in hop_ids)
    if m * biggest * biggest <= FUSED_COUNT_LIMIT:
        partner, is_left = _quad_partner(m, hop_ids[0].device)
        per_hop = []
        for st in range(lp1):
            tbl = hop_ids[st][:, :, None]
            cols = []
            for h in range(lp1):
                occ = hop_ids[h]
                cnt = lambda o: (tbl == o[:, None, :]).sum(-1).to(torch.float32) / o.shape[1]
                c_self, c_part = cnt(occ), cnt(occ[partner])
                cols.append(torch.stack([torch.where(is_left, c_self, c_part),
                                         torch.where(is_left, c_part, c_self)], dim=-1))
            per_hop.append(torch.stack(cols, dim=-1))
    else:
        per_hop = _hop_position_counts_join(hop_ids, num_nodes)
    return tuple(torch.where((hop_ids[st] != 0)[..., None, None], per_hop[st], 0.0)
                 for st in range(lp1))


def walk_position_counts(walk_ids: torch.Tensor, hop_ids: tuple, num_nodes: int) -> torch.Tensor:
    """(M, W, L+1, 2, L+1) counts of every walk step: the hop counts along
    the walks' alignment (walk step st is a hop-st entry), pads zeroed."""
    w = walk_ids.shape[1]
    per_hop = hop_position_counts(hop_ids, num_nodes)
    counts = torch.stack([expand_to_walks(c, w) for c in per_hop], dim=2)
    return torch.where((walk_ids != 0)[..., None, None], counts, 0.0)


def _pair_keys(hop_ids: tuple):
    """Left and right quad rows, and each quad row's pair index."""
    m = hop_ids[0].shape[0]
    b, dev = m // 4, hop_ids[0].device
    ar = lambda a, z: torch.arange(a, z, device=dev)
    li, ri = torch.cat([ar(0, b), ar(2 * b, 3 * b)]), torch.cat([ar(b, 2 * b), ar(3 * b, 4 * b)])
    pair_of_quad = torch.empty(m, dtype=torch.int64, device=dev)
    pair_of_quad[li] = ar(0, 2 * b)
    pair_of_quad[ri] = ar(0, 2 * b)
    return li, ri, pair_of_quad


def _occurrence_counts(q_keys, occ: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Multiplicity of each (pair, node) key of ``q_keys`` among the pairs'
    occurrences ``occ`` (2B, K**h), / K**h: the right minus the left
    insertion point in the sorted occurrence keys."""
    pair = torch.arange(occ.shape[0], device=occ.device)[:, None]
    occ_keys = torch.sort((pair * num_nodes + occ.long()).reshape(-1)).values
    left = torch.searchsorted(occ_keys, q_keys, side="left")
    right = torch.searchsorted(occ_keys, q_keys, side="right")
    return (right - left).to(torch.float32) / occ.shape[1]


def _hop_position_counts_join(hop_ids: tuple, num_nodes: int) -> list:
    """The hop counts by a sorted-key join (memory-lean for large trees)."""
    lp1 = len(hop_ids)
    li, ri, pair_of_quad = _pair_keys(hop_ids)
    out = []
    for st in range(lp1):
        q_keys = pair_of_quad[:, None] * num_nodes + hop_ids[st].long()
        counts = torch.stack([
            torch.stack([_occurrence_counts(q_keys, hop_ids[h][rows], num_nodes)
                         for h in range(lp1)], dim=-1)
            for rows in (li, ri)], dim=-2)
        out.append(counts)
    return out


def walk_position_counts_join(walk_ids: torch.Tensor, hop_ids: tuple,
                              num_nodes: int) -> torch.Tensor:
    """The walk counts by the join at walk granularity, without the pad
    zeroing (the JAX package's cross-check of the fused compare)."""
    lp1 = walk_ids.shape[2]
    li, ri, pair_of_quad = _pair_keys(hop_ids)
    q_keys = pair_of_quad[:, None, None] * num_nodes + walk_ids.long()
    return torch.stack([
        torch.stack([_occurrence_counts(q_keys, hop_ids[h][rows], num_nodes)
                     for h in range(lp1)], dim=-1)
        for rows in (li, ri)], dim=-2)


def _lstm_cell(gates: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
    return c_new, sigmoid(o) * torch.tanh(c_new)


class TreeBiLSTMEncoder(nn.Module):
    """A BiLSTM over walks read at each walk's last valid step, evaluated
    on the hop tree: the forward direction scans the hops (a parent's
    state broadcast to its K children), and the backward direction's output
    there is its first step, one cell application from the zero state.
    ``hidden_dim`` is split between the directions. Parameters per
    direction: ``{fwd,bwd}_wx`` (D, 4H), ``_wh`` (H, 4H), ``_b`` and
    ``_bh`` (4H,), gates [i | f | g | o], each U(+-1/sqrt(H)) as torch's
    ``nn.LSTM``; ``bwd_wh`` is never read (the backward step starts from
    h = 0) and gets no gradient. ``compute_dtype``: the inputs, the weights
    (and the sum of the two biases), h and c in that dtype, the output f32."""

    def __init__(self, input_dim: int, hidden_dim: int, gen: torch.Generator,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        h1 = hidden_dim // 2
        bound = h1**-0.5
        self.h1 = h1
        for prefix in ("fwd", "bwd"):
            self.register_parameter(f"{prefix}_wx",
                                    nn.Parameter(_uniform((input_dim, 4 * h1), bound, gen)))
            self.register_parameter(f"{prefix}_wh",
                                    nn.Parameter(_uniform((h1, 4 * h1), bound, gen)))
            self.register_parameter(f"{prefix}_b", nn.Parameter(_uniform((4 * h1,), bound, gen)))
            self.register_parameter(f"{prefix}_bh", nn.Parameter(_uniform((4 * h1,), bound, gen)))

    def forward(self, hop_x: tuple, lengths: torch.Tensor) -> torch.Tensor:
        """hop_x[st] (M, K**st, D), lengths (M, W) -> (M, W, 2 H) f32."""
        m, w = lengths.shape
        cd = self.compute_dtype
        hop_x = [x.to(cd) for x in hop_x]
        param = lambda name: getattr(self, name).to(cd)

        def select_last(hs):
            out = torch.zeros((m, w, hs[0].shape[-1]), dtype=hs[0].dtype, device=hs[0].device)
            for st, h_st in enumerate(hs):
                out = torch.where((lengths == st + 1)[..., None], expand_to_walks(h_st, w), out)
            return out

        b_f = param("fwd_b") + param("fwd_bh")
        c = torch.zeros((m, 1, self.h1), dtype=hop_x[0].dtype, device=hop_x[0].device)
        h, hs = None, []
        for x in hop_x:
            gates = x @ param("fwd_wx") + b_f
            if h is not None:
                rep = x.shape[1] // h.shape[1]
                c = torch.repeat_interleave(c, rep, dim=1)
                gates = gates + torch.repeat_interleave(h, rep, dim=1) @ param("fwd_wh")
            c, h = _lstm_cell(gates, c)
            hs.append(h)
        b_b = param("bwd_b") + param("bwd_bh")
        hs_b = [_lstm_cell(x @ param("bwd_wx") + b_b, torch.zeros_like(x[..., : self.h1]))[1]
                for x in hop_x]
        return torch.cat([select_last(hs), select_last(hs_b)], dim=-1).float()


class CAWNNet(nn.Module):
    def __init__(
        self,
        node_dim: int,
        edge_dim: int,
        gen: torch.Generator,
        time_feat_dim: int = 100,
        position_feat_dim: int = 172,
        walk_length: int = 1,
        num_walk_heads: int = 8,
        dropout: float = 0.1,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.time_encoder = TimeEncoder(time_feat_dim)
        self.position_fc1 = linear(walk_length + 1, position_feat_dim, gen)
        self.position_fc2 = linear(position_feat_dim, position_feat_dim, gen)
        input_dim = node_dim + time_feat_dim + edge_dim + position_feat_dim
        attention_dim = input_dim // 2
        if attention_dim % num_walk_heads:
            attention_dim += num_walk_heads - attention_dim % num_walk_heads
        self.feature_encoder = TreeBiLSTMEncoder(input_dim, input_dim, gen, compute_dtype)
        self.position_encoder = TreeBiLSTMEncoder(position_feat_dim, position_feat_dim, gen,
                                                  compute_dtype)
        enc_dim = 2 * (input_dim // 2) + 2 * (position_feat_dim // 2)
        self.projection_0 = linear(enc_dim, attention_dim, gen)
        self.walk_transformer = TransformerEncoder(attention_dim, num_walk_heads, dropout, gen,
                                                   compute_dtype)
        self.projection_1 = linear(attention_dim, node_dim, gen)

    def forward(
        self,
        tables: FeatureTables,
        inputs: CAWNInputs,
        *,
        dropout_gen: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Embeddings (M, Dn) of the quad's rows. In train mode with dropout
        > 0, ``dropout_gen`` draws the masks."""
        cd = self.compute_dtype
        hop_counts = hop_position_counts(inputs.hop_ids, tables.node.shape[0])
        pos_hop = tuple(
            project(self.position_fc2, torch.relu(project(self.position_fc1, c, cd)), cd)
            .sum(dim=-2) for c in hop_counts)
        combined = []
        for st, pos in enumerate(pos_hop):
            dt = (inputs.query_ts[:, None] - inputs.hop_ts[st]).to(torch.float32)
            combined.append(torch.cat([
                tables.node[inputs.hop_ids[st].long()].to(cd), self.time_encoder(dt).to(cd),
                tables.edge[inputs.hop_eids[st].long()].to(cd), pos], dim=-1))
        lengths = (inputs.walk_ids != 0).sum(dim=-1)
        x = torch.cat([self.feature_encoder(combined, lengths),
                       self.position_encoder(pos_hop, lengths)], dim=-1)
        x = self.walk_transformer(project(self.projection_0, x, cd).float(),
                                  dropout_gen=dropout_gen)
        return self.projection_1(x.mean(dim=-2))


@dataclasses.dataclass
class CAWN:
    """Backbone adapter: sampling and the net's construction (paired)."""

    num_neighbors: int = 32
    walk_length: int = 1
    num_walk_heads: int = 8
    dropout: float = 0.1
    time_feat_dim: int = 100
    position_feat_dim: int = 172
    sample_strategy: str = "time_interval_aware"
    # "auto" is float32 (the JAX package's bfloat16 is a TPU choice), or
    # "float32" or "bfloat16"
    compute_dtype: str = "auto"
    # the position counts pair each row with its partner
    pair_independent: ClassVar[bool] = False

    def __post_init__(self):
        check_strategy(self.sample_strategy)
        self._compute_dtype = compute_dtype_of(
            "float32" if self.compute_dtype == "auto" else self.compute_dtype)

    def build(self, node_dim: int, edge_dim: int, gen: torch.Generator) -> CAWNNet:
        """A CAWNNet whose parameters are drawn from ``gen`` (on the CPU)."""
        return CAWNNet(
            node_dim, edge_dim, gen,
            time_feat_dim=self.time_feat_dim,
            position_feat_dim=self.position_feat_dim,
            walk_length=self.walk_length,
            num_walk_heads=self.num_walk_heads,
            dropout=self.dropout,
            compute_dtype=self._compute_dtype,
        )

    def sample(
        self, csr: TemporalCSR, ids: torch.Tensor, ts: torch.Tensor,
        gen: torch.Generator | None = None,
    ) -> CAWNInputs:
        """The hop tables of the queries' walk trees; the stochastic
        strategies draw from ``gen``."""
        ids, ts = ids.to(torch.int32), ts.to(torch.int32)
        m, w = ids.shape[0], self.num_neighbors**self.walk_length
        blocks = sample_multi_hop(csr, ids, ts, self.num_neighbors, self.walk_length,
                                  self.sample_strategy, gen=gen)
        hop_ids = (ids[:, None],) + tuple(blk.nbr.reshape(m, -1) for blk in blocks)
        hop_eids = (torch.zeros_like(ids)[:, None],) + tuple(blk.eid.reshape(m, -1)
                                                             for blk in blocks)
        hop_ts = (ts[:, None],) + tuple(blk.ts.reshape(m, -1) for blk in blocks)
        walk_ids = torch.stack([expand_to_walks(a, w) for a in hop_ids], dim=2)
        return CAWNInputs(walk_ids, ts, hop_ids, hop_eids, hop_ts)
