"""TGAT: temporal graph attention network, unrolled over sampled hops.

Counterpart of ``dyglib_tpu/models/tgat.py`` (f32 or bf16 compute, the
``recent``, ``uniform`` and ``time_interval_aware`` strategies;
``compute_dtype`` "auto" is f32, where
the JAX package's "auto" picks bf16 on its TPU timings). The multi-hop neighborhood is sampled once into fixed-shape hop
tensors (hop h: (B, K**h)) and the layers are evaluated bottom-up:

    feats^0[h] = raw_node_features[hop_ids[h]]
    feats^l[h] = Merge_l(MHA_l(q = feats^{l-1}[h],
                               kv = feats^{l-1}[h+1] || edge || Phi(dt)),
                         raw[hop_ids[h]])
    output     = feats^L[0]

Layer l's convolution and merge parameters are shared across hop levels.
The query's own time feature is Phi(0); a neighbor's is Phi(t_query -
t_neighbor), the delta taken exactly in int32 and then cast to f32; the
attention mask is neighbor id != 0; layer-0 features are raw node rows.

Kernels (``ops/``): at layer 1, whose kv rows are raw feature rows, the
gathered-attention kernel (rows gathered from the tables or fetched from
``csr.feat_entry``) or the window-attention kernel (rows read straight from
``csr.feat_entry`` windows); at the layers above, the fused temporal
attention kernel; with ``use_phi_fusion``, the Phi projection kernel at
every layer instead. ``use_kernels`` (the net's, set from the adapter's at
``build``) calls the kernels' wrappers, which launch them on CUDA tensors
and take the plain versions on CPU tensors; ``use_kernels=False`` calls the
plain versions on any device. ``sample`` launches no kernel. Each kernel
is a ``torch.autograd.Function`` whose backward launches its backward
kernel, so TGAT trains on the card through the same kernels it evaluates
with. The window kernel runs only under ``recent`` (a stochastic draw is
no contiguous window); ``uniform`` and ``time_interval_aware`` draw their
neighbors from the ``torch.Generator`` its caller passes to ``sample``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from ..graph.csr import TemporalCSR
from ..graph.sampler import check_strategy, fetch_entry_windows, sample_multi_hop
from ..nn.modules import MergeLayer, TemporalMultiHeadAttention, TimeEncoder
from .base import FeatureTables, compute_dtype_of


class TGATInputs(NamedTuple):
    """Sampled hop tensors; level h arrays have shape (B, K**h)."""

    hop_ids: tuple  # h = 0..L: int32 node ids (level 0 = query nodes)
    hop_eids: tuple  # h = 1..L: int32 edge ids
    hop_ts: tuple  # h = 0..L: int32 time keys (level 0 = query times)
    hop_mask: tuple  # h = 1..L: bool validity masks
    # features fetched from csr.feat_entry windows, per hop from 1:
    # (B, K**h, Dn) node and (B, K**h, De) edge rows, equal to the table
    # gathers (invalid entries zeroed like id-0 rows); None: the net gathers
    # them. With the window kernel the last hop's are left out: the kernel
    # reads them itself.
    hop_node_feat: tuple | None = None
    hop_edge_feat: tuple | None = None
    # window kernel: per hop, each query's clamped window start in
    # csr.feat_entry (guard offset applied; that hop's query shape), and
    # the table itself
    hop_win_start: tuple | None = None
    feat_table: torch.Tensor | None = None


class TGATNet(nn.Module):
    """The differentiable part of TGAT (see the module docstring)."""

    def __init__(
        self,
        node_dim: int,
        edge_dim: int,
        gen: torch.Generator,
        time_feat_dim: int = 100,
        num_layers: int = 2,
        num_heads: int = 2,
        dropout: float = 0.1,
        use_pallas: bool = False,
        use_window_kernel: bool = False,
        use_gathered_kernel: bool = False,
        use_phi_fusion: bool = False,
        use_kernels: bool = True,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.use_window_kernel = use_window_kernel
        self.use_gathered_kernel = use_gathered_kernel
        self.use_phi_fusion = use_phi_fusion
        self.use_kernels = use_kernels
        self.time_encoder = TimeEncoder(time_feat_dim)
        for l in range(num_layers):
            self.add_module(
                f"temporal_conv_{l}",
                TemporalMultiHeadAttention(
                    node_dim, edge_dim, time_feat_dim, num_heads, dropout, gen,
                    use_pallas=use_pallas, compute_dtype=compute_dtype,
                ),
            )
            self.add_module(
                f"merge_{l}", MergeLayer(node_dim + time_feat_dim + node_dim, node_dim, node_dim, gen)
            )

    def forward(
        self,
        tables: FeatureTables,
        inputs: TGATInputs,
        *,
        dropout_gen: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Embeddings (B, Dn) of the level-0 queries. In train mode with
        dropout > 0, ``dropout_gen`` (on the inputs' device) draws the
        masks."""
        L = self.num_layers
        # layer-1 kv rows are raw features: the window kernel may read them
        fused = self.use_window_kernel and inputs.hop_win_start is not None
        b = inputs.hop_ids[0].shape[0]
        flat_ids = [ids.reshape(-1) for ids in inputs.hop_ids]
        flat_ts = [ts.reshape(-1) for ts in inputs.hop_ts]
        if inputs.hop_node_feat is not None:
            dn = tables.node_dim
            feats = [tables.node[flat_ids[0].long()]] + [
                nf.reshape(-1, dn) for nf in inputs.hop_node_feat
            ]
        else:
            ids_needed = flat_ids[:L] if fused else flat_ids
            feats = [tables.node[ids.long()] for ids in ids_needed]
        base_feats = list(feats)  # the merge layers' side input
        tw, tb = self.time_encoder.w, self.time_encoder.b
        kw = dict(use_kernels=self.use_kernels, dropout_gen=dropout_gen)

        for l in range(1, L + 1):
            conv = getattr(self, f"temporal_conv_{l - 1}")
            merge = getattr(self, f"merge_{l - 1}")
            new_feats = []
            for h in range(0, L - l + 1):
                m = flat_ids[h].shape[0]
                kk = flat_ids[h + 1].shape[0] // m
                q_feat = feats[h]
                # exact int32 delta, then f32
                dt = (flat_ts[h][:, None] - flat_ts[h + 1].reshape(m, kk)).to(torch.float32)
                zeros = torch.zeros((m, 1), dtype=torch.float32, device=dt.device)
                phi_0 = self.time_encoder(zeros)[:, 0, :]
                mask = inputs.hop_mask[h].reshape(m, kk)
                if l == 1 and fused:
                    window = (inputs.hop_win_start[h].reshape(-1), dt, inputs.feat_table, (tw, tb))
                    out, _ = conv(q_feat, phi_0, None, None, None, mask, window=window, **kw)
                elif l == 1 and self.use_gathered_kernel:
                    if inputs.hop_edge_feat is not None:
                        edge_flat = inputs.hop_edge_feat[h].reshape(m * kk, -1)
                    else:
                        edge_flat = tables.edge[inputs.hop_eids[h].reshape(-1).long()]
                    gathered = (feats[h + 1], edge_flat, dt, (tw, tb))
                    out, _ = conv(q_feat, phi_0, None, None, None, mask, gathered=gathered, **kw)
                else:
                    kv_feat = feats[h + 1].reshape(m, kk, -1)
                    if inputs.hop_edge_feat is not None:
                        edge_feat = inputs.hop_edge_feat[h].reshape(m, kk, -1)
                    else:
                        edge_feat = tables.edge[inputs.hop_eids[h].reshape(m, kk).long()]
                    if self.use_phi_fusion:
                        out, _ = conv(q_feat, phi_0, kv_feat, None, edge_feat, mask,
                                      time_fused=(dt, (tw, tb)), **kw)
                    else:
                        out, _ = conv(q_feat, phi_0, kv_feat, self.time_encoder(dt), edge_feat,
                                      mask, **kw)
                new_feats.append(merge(out, base_feats[h]))
            feats = new_feats
        return feats[0].reshape(b, -1)


def _resolve(flag: bool | str, auto: bool) -> bool:
    return auto if flag == "auto" else bool(flag)


@dataclasses.dataclass
class TGAT:
    """Backbone adapter: sampling and the net's construction."""

    num_neighbors: int = 20
    num_layers: int = 2
    num_heads: int = 2
    dropout: float = 0.1
    time_feat_dim: int = 100
    sample_strategy: str = "recent"
    # The kernel flags take the JAX package's names and precedence (window,
    # then gathered, then Phi fusion at layer 1). "auto" resolves to the
    # fused attention kernel at the upper layers and the gathered (or, with
    # the entry table, the window) attention kernel at layer 1: the JAX
    # package resolves the first two off on TPU timings, which do not carry
    # over to the card (ROADMAP.md). The gathered kernel's "auto" yields to
    # an explicit use_phi_fusion=True, so that flag means what it means in
    # the JAX package.
    use_fused_attention: bool | str = "auto"
    # on with "auto" whenever the trainer builds csr.feat_entry
    use_window_attention: bool | str = "auto"
    use_gathered_attention: bool | str = "auto"
    # an explicit choice: it takes the place of the attention kernels
    use_phi_fusion: bool | str = "auto"
    # "auto" (float32 on the card), "float32" or "bfloat16": the attention
    # layers' compute dtype (the merge layers stay f32, as in the JAX package)
    compute_dtype: str = "auto"
    # ask the trainer for csr.feat_entry (window fetches of hop features)
    wants_entry_features: bool = False
    # embeddings depend only on (node, time): the trainer embeds the triple
    # [src, dst, neg_dst] and reuses src's rows for neg_src
    pair_independent: bool = True
    # the built net's initial setting; the net's own ``use_kernels`` is
    # the switch from then on
    use_kernels: bool = True

    def __post_init__(self):
        check_strategy(self.sample_strategy)
        self._compute_dtype = compute_dtype_of(
            "float32" if self.compute_dtype == "auto" else self.compute_dtype)
        # windows of feat_entry exist only under recent (JAX tgat.py:243-246)
        self._window_kernel = (
            _resolve(self.use_window_attention, self.wants_entry_features)
            and self.sample_strategy == "recent"
        )
        self._gathered_kernel = (
            _resolve(self.use_gathered_attention, not _resolve(self.use_phi_fusion, False))
            and not self._window_kernel
        )
        self._phi_fusion = (
            _resolve(self.use_phi_fusion, False)
            and not self._window_kernel and not self._gathered_kernel
        )
        self._fused_attention = _resolve(self.use_fused_attention, True)

    @property
    def entry_window_rows(self) -> int:
        """Guard-pad rows the entry table needs for this model's windows."""
        return self.num_neighbors

    def build(self, node_dim: int, edge_dim: int, gen: torch.Generator) -> TGATNet:
        """A TGATNet whose parameters are drawn from ``gen`` (on the CPU)."""
        return TGATNet(
            node_dim, edge_dim, gen,
            time_feat_dim=self.time_feat_dim,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            dropout=self.dropout,
            use_pallas=self._fused_attention,
            use_window_kernel=self._window_kernel,
            use_gathered_kernel=self._gathered_kernel,
            use_phi_fusion=self._phi_fusion,
            use_kernels=self.use_kernels,
            compute_dtype=self._compute_dtype,
        )

    def sample(
        self, csr: TemporalCSR, ids: torch.Tensor, ts: torch.Tensor,
        gen: torch.Generator | None = None,
    ) -> TGATInputs:
        """The hop tensors of queries (ids, ts); under ``recent`` with
        ``csr.feat_entry`` the hop features too, and with the window kernel
        each hop's windows. ``uniform`` and ``time_interval_aware`` (on a
        CSR built with ``with_tia=True``) draw from ``gen`` (on the CSR's
        device), hop after hop."""
        k = self.num_neighbors
        b = ids.shape[0]
        ids, ts = ids.to(torch.int32), ts.to(torch.int32)
        blocks, wins = sample_multi_hop(
            csr, ids, ts, k, self.num_layers, self.sample_strategy, return_windows=True, gen=gen
        )
        hop_node_feat = hop_edge_feat = hop_win_start = feat_table = None
        fused = self._window_kernel and csr.feat_entry is not None and wins is not None
        if fused:
            pad = csr.feat_entry_guard_pad
            if k > pad:
                raise ValueError(f"num_neighbors={k} exceeds the feat_entry guard pad {pad}")
            t_max = csr.feat_entry.shape[0] - k
            hop_win_start = tuple((w + pad).clamp(0, t_max).to(torch.int32) for w in wins)
            feat_table = csr.feat_entry
        if csr.feat_entry is not None and wins is not None:
            dn = csr.feat_entry_node_dim
            pairs = list(zip(blocks, wins))
            if fused:
                pairs = pairs[:-1]  # the kernel reads the last hop's rows
            node_fs, edge_fs = [], []
            for blk, win in pairs:
                rows = torch.where(blk.mask[..., None], fetch_entry_windows(csr, win, k), 0.0)
                node_fs.append(rows[..., :dn].reshape(b, -1, dn).contiguous())
                edge_fs.append(rows[..., dn:].reshape(b, -1, rows.shape[-1] - dn).contiguous())
            hop_node_feat, hop_edge_feat = tuple(node_fs), tuple(edge_fs)
        return TGATInputs(
            hop_ids=(ids,) + tuple(blk.nbr.reshape(b, -1) for blk in blocks),
            hop_eids=tuple(blk.eid.reshape(b, -1) for blk in blocks),
            hop_ts=(ts,) + tuple(blk.ts.reshape(b, -1) for blk in blocks),
            hop_mask=tuple(blk.mask.reshape(b, -1) for blk in blocks),
            hop_node_feat=hop_node_feat,
            hop_edge_feat=hop_edge_feat,
            hop_win_start=hop_win_start,
            feat_table=feat_table,
        )
