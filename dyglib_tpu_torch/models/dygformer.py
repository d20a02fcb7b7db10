"""DyGFormer: patched transformer over full first-hop histories with
neighbor co-occurrence encoding.

Counterpart of ``dyglib_tpu/models/dygformer.py`` (f32 compute, no
sequence sharding, no TPU layout aids). The semantics are the JAX
package's:

  * sequence = the target node first (edge id 0, t = query time), then its
    most recent ``min(maxlen, total) - 1`` interactions in chronological
    order, left-aligned, zero-padded at the END; ``valid = seq_ids != 0``;
  * dt = query_ts - seq_ts in int32, then cast to f32; time features
    cos(dt * w + b) zeroed at pads;
  * co-occurrence: per entry, its count in its own sequence and in the
    partner's, each count MLP-encoded (1 -> ced -> ReLU -> ced) and summed
    over the two; counts zeroed at pads AFTER counting;
  * four channels (node, edge, time, co-occurrence), each patch-flattened
    and projected to ced, stacked per patch token;
  * the src and dst token sequences concatenated and attended jointly by
    pre-LN blocks (exact-erf GELU, attention scale 1/sqrt(hd) in
    f32, NO padding mask), then split, mean-pooled and projected to the
    node-feature width.

Because there is no padding mask, the number of pad tokens (the sequence
bucket) changes the embeddings: callers must pick the bucket the JAX
package picks (``bucket_candidates`` and the trainer's ``_pick_bucket``).

Paired rows: a quad batch [src || dst || neg_src || neg_dst] pairs
left = [src, neg_src] with right = [dst, neg_dst]; a triple
[src || dst || neg_dst] (``triple=True``, valid when neg_src = src) pairs
left = [src, src] with right = [dst, neg_dst] and computes the src rows'
own channels and self-counts once. The output is always in quad order.

Kernels (``ops/``): the time channel, the co-occurrence counts, the
frozen node/edge channel projections and the entry-window fetch each have
a hand-written CUDA kernel; the time channel and the projections have
backward kernels too, behind ``torch.autograd.Function``s. With
``use_kernels`` (the default) the net calls the kernels' wrappers, which
launch the kernels on CUDA tensors and take their plain versions on CPU
tensors; ``use_kernels=False`` calls the plain PyTorch versions on any
device. ``sample`` launches no kernel, so the net's flag is the one
switch. Unlike the JAX package, the patch kernel also runs
at patch 1 (it is then a plain projection of the gathered rows).

Training: in train mode the transformer's dropout draws its masks from a
``torch.Generator`` the caller passes (the trainer owns one, seeded from
``fit``'s seed), never from the global RNG.

Entry fetch (``use_entry_fetch``, default off as in the JAX package):
``sample`` records where each row's node and edge features lie in
``csr.feat_entry`` (target row, then the recent window, one contiguous
run), and the net fetches them there in place of the per-table gathers;
the two give bitwise-equal tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.csr import TemporalCSR
from ..graph.sampler import window_bounds
from ..nn.modules import LN_EPS, TimeEncoder, dropout, linear
from ..ops import (
    cooccurrence_counts,
    cooccurrence_counts_plain,
    fetch_sequence_features,
    fetch_sequence_features_plain,
    patch_projection,
    time_channel_projection,
)
from .base import FeatureTables


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class EntryWindow(NamedTuple):
    """Where each sequence's features lie in ``csr.feat_entry``: row 0 is
    the target's per-node row, rows 1..count the window from start."""

    table: torch.Tensor  # csr.feat_entry
    tgt_rows: torch.Tensor  # (M,) int32
    starts: torch.Tensor  # (M,) int32
    counts: torch.Tensor  # (M,) int32
    node_dim: int

    def fetch(self, seq_len: int, use_kernels: bool = True):
        """(M, seq_len, Dn) node and (M, seq_len, De) edge features, pads
        zero: through the kernel wrapper, or the plain version."""
        f = fetch_sequence_features if use_kernels else fetch_sequence_features_plain
        return f(self.table, self.tgt_rows, self.starts, self.counts, seq_len, self.node_dim)


class DyGFormerInputs(NamedTuple):
    seq_ids: torch.Tensor  # (M, Lp) int32 — target first, then chronological
    seq_eids: torch.Tensor  # (M, Lp) int32
    seq_ts: torch.Tensor  # (M, Lp) int32
    query_ts: torch.Tensor  # (M,) int32
    # set when sample read a csr with feat_entry and the backbone fetches:
    # the net then fetches the rows' features; None: it gathers them from
    # the tables
    entry_window: EntryWindow | None = None


class PreLNTransformerEncoder(nn.Module):
    """norm -> MHA -> residual; norm -> GELU FFN -> residual. No padding mask."""

    def __init__(self, attention_dim: int, num_heads: int, dropout: float, gen: torch.Generator):
        super().__init__()
        d = attention_dim
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        # nn.MultiheadAttention's init: xavier-uniform in-projections with
        # zero bias, default-Linear out-projection with zero bias
        self.q_proj = linear(d, d, gen, xavier=True, zero_bias=True)
        self.k_proj = linear(d, d, gen, xavier=True, zero_bias=True)
        self.v_proj = linear(d, d, gen, xavier=True, zero_bias=True)
        self.out_proj = linear(d, d, gen, zero_bias=True)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.ffn1 = linear(d, 4 * d, gen)
        self.ffn2 = linear(4 * d, d, gen)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, dropout_gen: torch.Generator | None = None) -> torch.Tensor:
        p = self.dropout if self.training else 0.0
        drop = lambda y: dropout(y, p, dropout_gen)
        b, t, d = x.shape
        hd = d // self.num_heads
        h = self.norm1(x)
        q = self.q_proj(h).view(b, t, self.num_heads, hd)
        k = self.k_proj(h).view(b, t, self.num_heads, hd)
        v = self.v_proj(h).view(b, t, self.num_heads, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        scores = drop(torch.softmax(attn, dim=-1))
        hidden = torch.einsum("bhqk,bkhd->bqhd", scores, v).reshape(b, t, d)
        x = x + drop(self.out_proj(hidden))
        h = self.norm2(x)
        h = F.gelu(self.ffn1(h))  # exact erf
        return x + drop(self.ffn2(drop(h)))


class DyGFormerNet(nn.Module):
    def __init__(
        self,
        node_dim: int,
        edge_dim: int,
        gen: torch.Generator,
        time_feat_dim: int = 100,
        channel_embedding_dim: int = 50,
        patch_size: int = 1,
        num_layers: int = 2,
        num_heads: int = 2,
        dropout: float = 0.1,
        use_kernels: bool = True,
    ):
        super().__init__()
        ced = channel_embedding_dim
        self.ced = ced
        self.patch_size = patch_size
        self.use_kernels = use_kernels
        self.co_occurrence_fc1 = linear(1, ced, gen)
        self.co_occurrence_fc2 = linear(ced, ced, gen)
        self.time_encoder = TimeEncoder(time_feat_dim)
        self.proj_node = linear(patch_size * node_dim, ced, gen)
        self.proj_edge = linear(patch_size * edge_dim, ced, gen)
        self.proj_time = linear(patch_size * time_feat_dim, ced, gen)
        self.proj_co_occurrence = linear(patch_size * ced, ced, gen)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(
                f"transformer_{i}",
                PreLNTransformerEncoder(4 * ced, num_heads, dropout, gen),
            )
        self.output_layer = linear(4 * ced, node_dim, gen)

    def _patches(self, x: torch.Tensor) -> torch.Tensor:
        m, lp, d = x.shape
        return x.reshape(m, lp // self.patch_size, self.patch_size * d)

    def _frozen_channel(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        if self.use_kernels:
            return patch_projection(x, lin.weight.t(), lin.bias, self.patch_size)
        return lin(self._patches(x))

    def forward(
        self,
        tables: FeatureTables,
        inputs: DyGFormerInputs,
        *,
        triple: bool = False,
        dropout_gen: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Quad-order embeddings (4B, Dn). In train mode with dropout > 0,
        ``dropout_gen`` (on the inputs' device) draws the dropout masks."""
        seq_ids = inputs.seq_ids
        m, lp = seq_ids.shape
        p = lp // self.patch_size
        ced = self.ced
        dev = seq_ids.device
        valid = seq_ids != 0  # (M, Lp)

        ar = lambda a, z: torch.arange(a, z, device=dev)
        if triple:
            b = m // 3
            li = torch.cat([ar(0, b), ar(0, b)])
            ri = torch.cat([ar(b, 2 * b), ar(2 * b, 3 * b)])
        else:
            b = m // 4
            li = torch.cat([ar(0, b), ar(2 * b, 3 * b)])
            ri = torch.cat([ar(b, 2 * b), ar(3 * b, 4 * b)])

        # ---- co-occurrence counts in pair space (2B rows): one launch for
        # the self counts (triple: the src rows once), one for both cross
        # directions
        count = cooccurrence_counts if self.use_kernels else cooccurrence_counts_plain
        ids_l, ids_r = seq_ids[li], seq_ids[ri]
        if triple:
            own = torch.cat([seq_ids[:b], ids_r])
            self_counts = count(own, own)
            cnt_ll, cnt_rr = self_counts[:b].repeat(2, 1), self_counts[b:]
        else:
            own = torch.cat([ids_l, ids_r])
            self_counts = count(own, own)
            cnt_ll, cnt_rr = self_counts[: 2 * b], self_counts[2 * b :]
        cross = count(torch.cat([ids_l, ids_r]), torch.cat([ids_r, ids_l]))
        cnt_lr, cnt_rl = cross[: 2 * b], cross[2 * b :]
        cnt_l = torch.stack([cnt_ll, cnt_lr], dim=-1)  # (2B, Lp, 2)
        cnt_r = torch.stack([cnt_rl, cnt_rr], dim=-1)
        cnt_l = torch.where(valid[li][..., None], cnt_l, 0.0)
        cnt_r = torch.where(valid[ri][..., None], cnt_r, 0.0)

        def co(cnt):
            h = torch.relu(self.co_occurrence_fc1(cnt[..., None]))
            return self.co_occurrence_fc2(h).sum(dim=2)  # (2B, Lp, ced)

        co_l, co_r = co(cnt_l), co(cnt_r)

        # ---- per-row channels (M rows, shared across pairs)
        if inputs.entry_window is None:
            node_feat = tables.node[seq_ids]  # (M, Lp, Dn)
            edge_feat = tables.edge[inputs.seq_eids]
        else:
            node_feat, edge_feat = inputs.entry_window.fetch(lp, self.use_kernels)
        dt = (inputs.query_ts[:, None] - inputs.seq_ts).to(torch.float32)
        node_ch = self._frozen_channel(self.proj_node, node_feat)
        edge_ch = self._frozen_channel(self.proj_edge, edge_feat)
        if self.use_kernels:
            time_ch = time_channel_projection(
                dt, valid, self.time_encoder.w.reshape(-1), self.time_encoder.b,
                self.proj_time.weight.t(), self.proj_time.bias, self.patch_size,
            )
        else:
            time_feat = torch.where(valid[..., None], self.time_encoder(dt), 0.0)
            time_ch = self.proj_time(self._patches(time_feat))
        co_pl = self.proj_co_occurrence(self._patches(co_l))  # (2B, P, ced)
        co_pr = self.proj_co_occurrence(self._patches(co_r))

        row_ch = (node_ch, edge_ch, time_ch)  # each (M, P, ced)
        xl = torch.stack([c[li] for c in row_ch] + [co_pl], dim=2).reshape(2 * b, p, 4 * ced)
        xr = torch.stack([c[ri] for c in row_ch] + [co_pr], dim=2).reshape(2 * b, p, 4 * ced)

        # ---- joint src||dst attention per pair
        joint = torch.cat([xl, xr], dim=1)
        for i in range(self.num_layers):
            joint = getattr(self, f"transformer_{i}")(joint, dropout_gen)
        emb_l = self.output_layer(joint[:, :p, :].mean(dim=1))
        emb_r = self.output_layer(joint[:, p:, :].mean(dim=1))
        return torch.cat([emb_l[:b], emb_r[:b], emb_l[b:], emb_r[b:]], dim=0)


@dataclasses.dataclass
class DyGFormer:
    """Backbone adapter for DyGFormerNet (paired, stateless, 'recent')."""

    max_input_sequence_length: int = 32
    patch_size: int = 1
    channel_embedding_dim: int = 50
    num_layers: int = 2
    num_heads: int = 2
    dropout: float = 0.1
    time_feat_dim: int = 100
    # the built net's initial setting; the net's own ``use_kernels`` is
    # the switch from then on
    use_kernels: bool = True
    # fetch node/edge features from csr.feat_entry (ops/window_fetch.py)
    # instead of two table gathers; off, as the JAX package resolves it,
    # until the card's numbers argue otherwise (PERF.md)
    use_entry_fetch: bool = False

    @property
    def seq_len(self) -> int:
        return _round_up(self.max_input_sequence_length, self.patch_size)

    @property
    def wants_entry_features(self) -> bool:
        """Ask the trainer to build csr.feat_entry (see use_entry_fetch)."""
        return self.use_entry_fetch

    @property
    def entry_window_rows(self) -> int:
        """Guard-pad rows the entry table needs for this model's windows."""
        return self.seq_len

    @property
    def bucket_candidates(self) -> tuple[int, ...]:
        """Patch-aligned sequence-length buckets {start, 2*start, ..., seq_len}."""
        start = _round_up(max(8, self.patch_size), self.patch_size)
        out = []
        c = start
        while c < self.seq_len:
            out.append(c)
            c *= 2
        out.append(self.seq_len)
        return tuple(out)

    def build(self, node_dim: int, edge_dim: int, gen: torch.Generator) -> DyGFormerNet:
        """A DyGFormerNet whose parameters are drawn from ``gen`` (on the CPU)."""
        return DyGFormerNet(
            node_dim, edge_dim, gen,
            time_feat_dim=self.time_feat_dim,
            channel_embedding_dim=self.channel_embedding_dim,
            patch_size=self.patch_size,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            dropout=self.dropout,
            use_kernels=self.use_kernels,
        )

    def sample(
        self,
        csr: TemporalCSR,
        ids: torch.Tensor,
        ts: torch.Tensor,
        seq_len: int | None = None,
    ) -> DyGFormerInputs:
        """Most recent interactions, left-aligned after the target.

        ``seq_len`` overrides the padded sequence length with a smaller
        bucket; histories are then truncated to the bucket's most recent
        seq_len - 1 entries, exactly what a maxlen = seq_len model sees.
        With ``use_entry_fetch`` and a CSR that holds ``feat_entry``, the
        inputs carry the rows' windows in that table, for the net to fetch.
        """
        total = self.seq_len if seq_len is None else seq_len
        ids = ids.to(torch.int32)
        ts = ts.to(torch.int32)
        k = min(self.max_input_sequence_length, total) - 1
        # the recent window is the contiguous CSR range [max(lo, hi-k), hi)
        lo, hi = window_bounds(csr, ids, ts)
        start = torch.maximum(lo, hi - k)
        idx = start[:, None] + torch.arange(k, dtype=torch.int32, device=ids.device)[None, :]
        valid = idx < hi[:, None]
        safe = idx.clamp(0, csr.num_entries - 1)
        nbr = torch.where(valid, csr.nbr[safe], 0)
        eid = torch.where(valid, csr.eid[safe], 0)
        tsn = torch.where(valid, csr.ts[safe], 0)
        pad_cols = total - 1 - k
        if pad_cols > 0:
            z = torch.zeros((ids.shape[0], pad_cols), dtype=torch.int32, device=ids.device)
            nbr, eid, tsn = (torch.cat([a, z], dim=1) for a in (nbr, eid, tsn))
        zeros = torch.zeros_like(ids)[:, None]
        window = None
        if self.use_entry_fetch and csr.feat_entry is not None:
            pad = csr.feat_entry_guard_pad
            if k > pad:
                raise ValueError(f"window of {k} entries exceeds the feat_entry guard pad {pad}")
            window = EntryWindow(
                csr.feat_entry, 2 * pad + csr.num_entries + ids, start + pad, hi - start,
                csr.feat_entry_node_dim,
            )
        return DyGFormerInputs(
            seq_ids=torch.cat([ids[:, None], nbr], dim=1),
            seq_eids=torch.cat([zeros, eid], dim=1),
            seq_ts=torch.cat([ts[:, None], tsn], dim=1),
            query_ts=ts,
            entry_window=window,
        )
