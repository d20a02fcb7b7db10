"""Shared neural modules.

Counterpart of ``dyglib_tpu/nn/modules.py`` (``LN_EPS``, the torch-init
helpers, ``TimeEncoder``, ``MergeLayer``, ``TemporalMultiHeadAttention``)
and the inverted ``dropout`` the port's models share. Parameters are drawn
from an explicit ``torch.Generator`` so a seed fixes the whole model:

  * ``linear``: torch ``nn.Linear``'s default distribution,
    weight and bias U(+-1/sqrt(fan_in)) (the JAX package's ``TorchLinear``);
    ``xavier=True`` gives ``nn.init.xavier_uniform_`` (attention in/out
    projections), ``zero_bias=True`` a zero bias, ``bias=False`` none;
  * ``TimeEncoder``: cos(t * w + b) with w the fixed spectrum
    1/10**linspace(0, 9, Dt), stored (1, Dt), and b = 0.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import ops
from ..ops._attention import attend

LN_EPS = 1e-5  # torch nn.LayerNorm default


def _uniform(shape, bound: float, gen: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


@torch.no_grad()
def linear(
    fan_in: int, fan_out: int, gen: torch.Generator, *, xavier: bool = False,
    zero_bias: bool = False, bias: bool = True,
) -> nn.Linear:
    """An ``nn.Linear`` whose weight, then bias, are drawn from ``gen`` (the
    global RNG is not touched)."""
    lin = torch.nn.utils.skip_init(nn.Linear, fan_in, fan_out, bias=bias)
    bound = (6.0 / (fan_in + fan_out)) ** 0.5 if xavier else fan_in**-0.5
    lin.weight.copy_(_uniform(lin.weight.shape, bound, gen))
    if not bias:
        return lin
    if zero_bias:
        lin.bias.zero_()
    else:
        lin.bias.copy_(_uniform(lin.bias.shape, fan_in**-0.5, gen))
    return lin


def dropout(x: torch.Tensor, p: float, gen: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with masks drawn from ``gen`` (keep w.p. 1 - p)."""
    if p == 0.0:
        return x
    if gen is None:
        raise ValueError("dropout in train mode needs a torch.Generator (dropout_gen)")
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return x * keep / (1.0 - p)


def time_encoder_spectrum(time_dim: int) -> np.ndarray:
    """The fixed 1/10^linspace(0,9,d) frequency init, shape (1, d)."""
    return (1.0 / 10 ** np.linspace(0, 9, time_dim, dtype=np.float32)).reshape(1, time_dim)


class TimeEncoder(nn.Module):
    """Cosine time features phi(t) = cos(w * t + b) with exact ``cos``."""

    def __init__(self, time_dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(time_encoder_spectrum(time_dim)))
        self.b = nn.Parameter(torch.zeros(time_dim))

    def forward(self, timestamps: torch.Tensor) -> torch.Tensor:
        """(...,) times -> (..., time_dim) features."""
        return torch.cos(timestamps[..., None] * self.w[0] + self.b)


class MergeLayer(nn.Module):
    """concat(x1, x2) -> Linear -> ReLU -> Linear."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, gen: torch.Generator):
        super().__init__()
        self.fc1 = linear(input_dim, hidden_dim, gen)
        self.fc2 = linear(hidden_dim, output_dim, gen)

    def forward(self, input_1: torch.Tensor, input_2: torch.Tensor) -> torch.Tensor:
        h = self.fc1(torch.cat([input_1, input_2], dim=-1))
        return self.fc2(torch.relu(h))


def _keep_mask(shape, p: float, gen: torch.Generator | None, device) -> torch.Tensor:
    """Attention-score dropout as a (M, H, K) keep mask pre-scaled by
    1 / (1 - p): ones when p is 0 (evaluation), the form every attention
    kernel takes."""
    return dropout(torch.ones(shape, device=device), p, gen)


class TemporalMultiHeadAttention(nn.Module):
    """Single-query temporal attention over K sampled neighbors.

    Counterpart of ``dyglib_tpu/nn/modules.py::TemporalMultiHeadAttention``
    (f32 compute), with its parameter names:

        query   = [node_feat || node_time_feat]             (1 token)
        key=val = [nbr_feat || edge_feat || nbr_time_feat]  (K tokens)

    projected by ``query_projection``, ``key_projection`` and
    ``value_projection`` (no bias); padded neighbors get logit -1e10, so an
    all-padded row attends uniformly instead of giving NaN; then
    ``residual_fc``, dropout and ``layer_norm(out + residual)``.

    Branches, in the JAX module's precedence, each the same math:
      * ``gathered=(feat_n, feat_e, dt, (tw, tb))``: layer-1 kv rows already
        gathered, Phi(dt) in the kernel (``ops.gathered_attention``);
      * ``window=(starts, dt, table, (tw, tb))``: kv rows read as windows
        of ``csr.feat_entry`` (``ops.window_attention``);
      * ``time_fused=(dt, (tw, tb))``: key = feat @ Wk[:Df] + Phi(dt) @
        Wk[Df:], the second term by ``ops.phi_projection``;
      * ``use_pallas``: ``ops.temporal_attention`` on the three kv parts;
      * otherwise the plain path (concatenate, ``nn.Linear``s, attend).
    The kernels read the projections' weights in place (``weight.t()``)
    and are autograd Functions whose backward launches their backward
    kernels: q3, the weights, the time encoder and (fused branch) the kv
    parts get gradients. ``use_kernels=False`` calls each kernel's plain
    version instead. The feature rows of the gathered and window branches
    are raw table rows: they get no gradient, on either path (detached).

    Dropout (train mode) draws from ``dropout_gen``: on the scores, as the
    kernels' pre-scaled ``keep`` mask, and on residual_fc's output.
    Returns (out (M, Dq), scores (M, H, K) after dropout, or None on the
    gathered and window branches, as in the JAX module).
    """

    def __init__(
        self, node_dim: int, edge_dim: int, time_dim: int, num_heads: int, dropout: float,
        gen: torch.Generator, use_pallas: bool = False,
    ):
        super().__init__()
        query_dim = node_dim + time_dim
        kv_dim = node_dim + edge_dim + time_dim
        if query_dim % num_heads:
            raise ValueError(f"query width {query_dim} does not split into {num_heads} heads")
        self.num_heads = num_heads
        self.dropout = dropout
        self.use_pallas = use_pallas
        self.query_projection = linear(query_dim, query_dim, gen, bias=False)
        self.key_projection = linear(kv_dim, query_dim, gen, bias=False)
        self.value_projection = linear(kv_dim, query_dim, gen, bias=False)
        self.residual_fc = linear(query_dim, query_dim, gen)
        self.layer_norm = nn.LayerNorm(query_dim, eps=LN_EPS)

    def forward(
        self,
        node_features: torch.Tensor,  # (M, Dn)
        node_time_features: torch.Tensor,  # (M, Dt)
        neighbor_node_features: torch.Tensor | None,  # (M, K, Dn)
        neighbor_time_features: torch.Tensor | None,  # (M, K, Dt)
        neighbor_edge_features: torch.Tensor | None,  # (M, K, De)
        neighbor_mask: torch.Tensor,  # (M, K) bool, True = real neighbor
        *,
        window: tuple | None = None,
        gathered: tuple | None = None,
        time_fused: tuple | None = None,
        use_kernels: bool = True,
        dropout_gen: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        p = self.dropout if self.training else 0.0
        heads = self.num_heads
        query = residual = torch.cat([node_features, node_time_features], dim=-1)
        q = self.query_projection(query)
        m, k = neighbor_mask.shape
        mask = neighbor_mask.to(torch.float32)
        keep = _keep_mask((m, heads, k), p, dropout_gen, q.device)
        wk, wv = self.key_projection.weight.t(), self.value_projection.weight.t()
        scores = None
        if gathered is not None:
            feat_n, feat_e, dt, (tw, tb) = gathered
            f = ops.gathered_attention if use_kernels else ops.gathered_attention_plain
            out = f(q, feat_n.detach(), feat_e.detach(), dt, mask, keep, (tw.reshape(-1), tb),
                    (wk, wv), heads)
        elif window is not None:
            starts, dt, table, (tw, tb) = window
            f = ops.window_attention if use_kernels else ops.window_attention_plain
            out = f(q, starts, dt, mask, keep, table.detach(), tw.reshape(-1), tb, (wk, wv), heads)
        elif time_fused is not None:
            dt, (tw, tb) = time_fused
            feat = torch.cat([neighbor_node_features, neighbor_edge_features], dim=-1)
            d_feat = feat.shape[-1]
            feat = feat.reshape(m * k, d_feat)
            proj = ops.phi_projection if use_kernels else ops.phi_projection_plain
            dt, tw = dt.reshape(-1), tw.reshape(-1)
            key = feat @ wk[:d_feat] + proj(dt, tw, tb, wk[d_feat:])
            val = feat @ wv[:d_feat] + proj(dt, tw, tb, wv[d_feat:])
            out, scores = attend(
                q, key.view(m, k, -1), val.view(m, k, -1), mask, keep, heads
            )
        elif self.use_pallas:
            f = ops.temporal_attention if use_kernels else ops.temporal_attention_plain
            out, scores = f(q, neighbor_node_features, neighbor_edge_features,
                            neighbor_time_features, mask, keep, wk, wv, heads)
        else:
            kv = torch.cat(
                [neighbor_node_features, neighbor_edge_features, neighbor_time_features], dim=-1
            )
            out, scores = attend(
                q, self.key_projection(kv), self.value_projection(kv), mask, keep, heads
            )
        out = dropout(self.residual_fc(out), p, dropout_gen)
        return self.layer_norm(out + residual), scores
