"""DyGFormer: patched transformer over full first-hop histories with
neighbor co-occurrence encoding.

Counterpart of ``dyglib_tpu/models/dygformer.py`` (f32 or bf16 compute,
``remat``; not its TPU layout aids ``pad_heads`` and ``fold_patch_proj``).
The semantics are the JAX package's:

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

Ulysses (``sequence_axis``, under a trainer's mesh): the channel
projections run on whole sequences; then each rank of the axis keeps its
shard of the joint tokens for LN, the projections and the FFN, the
attention runs on its heads over every token between two all-to-alls, and
the tokens are gathered again (differentiably) before the pooling. Plain
PyTorch, as the JAX package's is XLA's.

Training: in train mode the transformer's dropout draws its masks from a
``torch.Generator`` the caller passes (the trainer owns one, seeded from
``fit``'s seed), never from the global RNG.

bf16 compute (``compute_dtype="bfloat16"``; parameters stay f32): the
JAX package's roundings. The node, edge and co-occurrence channels are
bf16 linear layers (the product rounded, then its sum with the rounded
bias; the gathered node and edge rows cast to bf16), through the bf16
variants of the patch
projection and time channel kernels; the channels are stacked in f32; each
block's LayerNorm output, projections, attention products and FFN are
bf16, its scale, softmax and residuals f32. ``gelu_approximate`` (the
tanh GELU) and ``dropout_impl="bf16mask"`` (``nn.modules.bf16_mask_dropout``)
are the JAX package's fields of the same names.

Remat (``remat=True``): each block runs under
``torch.utils.checkpoint`` with a selective policy that saves the matmul
outputs (``mm``, ``addmm``, ``bmm``: the JAX package's
``dots_saveable``) and the dropout draws (``rand``: a recompute must not
draw new masks or advance the generator) and recomputes the rest in the
backward. ``preserve_rng_state=False``: the port draws from no global RNG,
and stashing the CUDA RNG state is not legal inside a graph capture.
Under ``sequence_axis`` the recompute repeats the block's two
all-to-alls: a remat train step makes six a block (two forward, two in the
recompute, two in the backward) where one without remat makes four.

Entry fetch (``use_entry_fetch``, default off as in the JAX package):
``sample`` records where each row's node and edge features lie in
``csr.feat_entry`` (target row, then the recent window, one contiguous
run), and the net fetches them there in place of the per-table gathers;
the two give bitwise-equal tensors.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import ClassVar, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..graph.csr import TemporalCSR
from ..graph.sampler import window_bounds
from ..nn.modules import (
    LN_EPS,
    TimeEncoder,
    bf16_mask_dropout,
    dropout,
    gelu,
    linear,
    project,
)
from ..parallel.mesh import all_gather, all_to_all
from ..ops import (
    cooccurrence_counts,
    cooccurrence_counts_plain,
    fetch_sequence_features,
    fetch_sequence_features_plain,
    patch_projection,
    time_channel_projection,
    time_channel_projection_plain,
)
from .base import FeatureTables, compute_dtype_of


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


_SAVED_OPS = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
              torch.ops.aten.rand}


def _remat_policy(ctx, op, *args, **kwargs):
    """Save the matmul outputs and the dropout draws; recompute the rest."""
    if op.overloadpacket in _SAVED_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_remat_contexts = functools.partial(create_selective_checkpoint_contexts, _remat_policy)

DROPOUT_IMPLS = {"flax": dropout, "bf16mask": bf16_mask_dropout}


class PreLNTransformerEncoder(nn.Module):
    """norm -> MHA -> residual; norm -> GELU FFN -> residual. No padding mask.

    ``compute_dtype``, ``gelu_approximate`` and ``dropout_impl`` are the JAX
    block's ``dtype``, ``gelu_approximate`` and ``dropout_impl``."""

    def __init__(self, attention_dim: int, num_heads: int, dropout: float, gen: torch.Generator,
                 compute_dtype: torch.dtype = torch.float32, gelu_approximate: bool = False,
                 dropout_impl: str = "flax"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.gelu_approximate = gelu_approximate
        self.dropout_fn = DROPOUT_IMPLS[dropout_impl]
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

    def forward(self, x: torch.Tensor, dropout_gen: torch.Generator | None = None,
                seq_group=None) -> torch.Tensor:
        """``seq_group = (mesh, axis)``: ``x`` is this rank's shard of the
        tokens (Ulysses); LN, the projections and the FFN run on it, and
        the attention on this rank's heads over every token, between two
        all-to-alls along ``axis`` (tokens -> heads, heads -> tokens)."""
        p = self.dropout if self.training else 0.0
        drop = lambda y: self.dropout_fn(y, p, dropout_gen)
        cd = self.compute_dtype
        b, t, d = x.shape
        hd = d // self.num_heads
        h = self.norm1(x).to(cd)
        q = project(self.q_proj, h, cd).view(b, t, self.num_heads, hd)
        k = project(self.k_proj, h, cd).view(b, t, self.num_heads, hd)
        v = project(self.v_proj, h, cd).view(b, t, self.num_heads, hd)
        if seq_group is not None:
            mesh, axis = seq_group
            # (3, b, t/n, H, hd) -> (3, b, t, H/n, hd)
            q, k, v = all_to_all(torch.stack([q, k, v]), mesh, axis, "dygformer/qkv",
                                 split_dim=3, cat_dim=2).unbind(0)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
        scores = drop(torch.softmax(attn, dim=-1))
        hidden = torch.einsum("bhqk,bkhd->bqhd", scores.to(cd), v)
        if seq_group is not None:  # (b, t, H/n, hd) -> (b, t/n, H, hd)
            hidden = all_to_all(hidden, mesh, axis, "dygformer/hidden", split_dim=1, cat_dim=2)
        hidden = hidden.reshape(b, t, d)
        x = x + drop(project(self.out_proj, hidden, cd).float())
        h = self.norm2(x).to(cd)
        h = gelu(project(self.ffn1, h, cd), self.gelu_approximate)  # exact erf by default
        return x + drop(project(self.ffn2, drop(h), cd).float())


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
        sequence_axis: str | None = None,
        compute_dtype: torch.dtype = torch.float32,
        remat: bool = False,
        gelu_approximate: bool = False,
        dropout_impl: str = "flax",
    ):
        super().__init__()
        ced = channel_embedding_dim
        self.ced = ced
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.num_heads = num_heads
        # Ulysses: with a mesh (set by a trainer) and an axis, the joint
        # token stream is sharded over that axis inside the encoder
        self.sequence_axis = sequence_axis
        self.mesh = None
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
                PreLNTransformerEncoder(4 * ced, num_heads, dropout, gen, compute_dtype,
                                        gelu_approximate, dropout_impl),
            )
        self.output_layer = linear(4 * ced, node_dim, gen)

    def _patches(self, x: torch.Tensor) -> torch.Tensor:
        m, lp, d = x.shape
        return x.reshape(m, lp // self.patch_size, self.patch_size * d)

    def _frozen_channel(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = x.to(cd)
        if self.use_kernels:
            return patch_projection(x, lin.weight.t(), lin.bias, self.patch_size, cd)
        return project(lin, self._patches(x), cd)

    def _encode(self, i: int, joint, dropout_gen, seq_group):
        layer = getattr(self, f"transformer_{i}")
        if not self.remat:
            return layer(joint, dropout_gen, seq_group)
        return checkpoint(layer, joint, dropout_gen, seq_group, use_reentrant=False,
                          preserve_rng_state=False, context_fn=_remat_contexts)

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

        # ---- per-row channels (M rows, shared across pairs); in bf16 the
        # gathered rows are cast, as the JAX package casts them
        cd = self.compute_dtype
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
                self.proj_time.weight.t(), self.proj_time.bias, self.patch_size, cd,
            )
        elif cd == torch.float32:
            time_feat = torch.where(valid[..., None], self.time_encoder(dt), 0.0)
            time_ch = self.proj_time(self._patches(time_feat))
        else:  # the time channel kernel's bf16 math
            time_ch = time_channel_projection_plain(
                dt, valid, self.time_encoder.w.reshape(-1), self.time_encoder.b,
                self.proj_time.weight.t(), self.proj_time.bias, self.patch_size, cd,
            )
        co_pl = project(self.proj_co_occurrence, self._patches(co_l), cd)  # (2B, P, ced)
        co_pr = project(self.proj_co_occurrence, self._patches(co_r), cd)

        # the channels stacked in f32 (bf16 channels promoted, as jnp.stack does)
        row_ch = (node_ch, edge_ch, time_ch)  # each (M, P, ced)
        xl = torch.stack([c[li].float() for c in row_ch] + [co_pl.float()],
                         dim=2).reshape(2 * b, p, 4 * ced)
        xr = torch.stack([c[ri].float() for c in row_ch] + [co_pr.float()],
                         dim=2).reshape(2 * b, p, 4 * ced)

        # ---- joint src||dst attention per pair
        joint = torch.cat([xl, xr], dim=1)
        seq_group = None
        if self.mesh is not None and self.sequence_axis is not None:
            seq_group = (self.mesh, self.sequence_axis)
            n, i = self.mesh.size(self.sequence_axis), self.mesh.index(self.sequence_axis)
            t = joint.shape[1]
            if t % n or self.num_heads % n:
                raise ValueError(f"sequence axis of {n} ranks must divide the {t} joint tokens "
                                 f"and the {self.num_heads} heads")
            joint = joint.narrow(1, i * (t // n), t // n)
        for i in range(self.num_layers):
            joint = self._encode(i, joint, dropout_gen, seq_group)
        if seq_group is not None:  # every token again, for the pooling
            joint = all_gather(joint, *seq_group, "dygformer/tokens", dim=1)
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
    # mesh axis over which the joint patch tokens are sharded (Ulysses);
    # None: unsharded. Its size must divide num_heads and the joint token
    # count 2 * seq_len / patch_size
    sequence_axis: str | None = None
    # "float32" or "bfloat16" (the JAX package's field; parameters stay f32)
    compute_dtype: str = "float32"
    # rematerialize each block in the backward (see the module docstring)
    remat: bool = False
    # tanh-approximate GELU; "auto" is off: the JAX package's "auto" turns
    # it on for its TPU timings, which do not carry over to the card
    gelu_approximate: bool | str = "auto"
    # "flax" (inverted dropout) or "bf16mask" (nn.modules.bf16_mask_dropout)
    dropout_impl: str = "flax"
    # where neg_src = src the net pairs the triple [src, dst, neg_dst]
    # itself (``triple=True``): src's rows serve both pairs, exactly
    triple_expand: ClassVar[bool] = True

    def __post_init__(self):
        compute_dtype_of(self.compute_dtype)
        if self.dropout_impl not in DROPOUT_IMPLS:
            raise ValueError(f"dropout_impl {self.dropout_impl!r} is not one of "
                             f"{sorted(DROPOUT_IMPLS)}")

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
            sequence_axis=self.sequence_axis,
            compute_dtype=compute_dtype_of(self.compute_dtype),
            remat=self.remat,
            gelu_approximate=self.gelu_approximate not in ("auto", False),
            dropout_impl=self.dropout_impl,
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
