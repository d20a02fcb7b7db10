"""Shared neural modules.

Counterpart of ``dyglib_tpu/nn/modules.py`` (``LN_EPS``, the torch-init
helpers, ``TimeEncoder``, ``FusedGRUCell``, ``FusedRNNCell``,
``MergeLayer``, ``MLPClassifier``, ``TemporalMultiHeadAttention``, the
post-LN ``TransformerEncoder``) and the inverted ``dropout`` the port's
models share. Parameters are drawn
from an explicit ``torch.Generator`` so a seed fixes the whole model:

  * ``linear``: torch ``nn.Linear``'s default distribution,
    weight and bias U(+-1/sqrt(fan_in)) (the JAX package's ``TorchLinear``);
    ``xavier=True`` gives ``nn.init.xavier_uniform_`` (attention in/out
    projections), ``zero_bias=True`` a zero bias, ``bias=False`` none;
  * ``project``: an ``nn.Linear`` applied in a compute dtype as the JAX
    package's ``TorchLinear(dtype=...)`` applies it (bf16: the product
    rounded, then its sum with the rounded bias); parameters stay f32;
  * ``TimeEncoder``: cos(t * w + b) with w the fixed spectrum
    1/10**linspace(0, 9, Dt), stored (1, Dt), and b = 0; ``trainable=False``
    (GraphMixer) freezes both: they stay in the state dict, with
    ``requires_grad=False``, where the JAX package keeps them in the tree
    and stops their gradient.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..ops._attention import NEG, attend

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


def project(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``lin(x)`` computed in ``dtype``, as the JAX package's
    ``TorchLinear(dtype=dtype)`` computes it: x and the weight rounded to
    ``dtype``, their product (f32 sums) rounded to ``dtype``, then its sum
    with the bias rounded to ``dtype``, a ``dtype`` result. float32 is
    ``lin(x)`` itself. Gradients reach the f32 parameters through the
    casts."""
    if dtype == torch.float32:
        return lin(x)
    y = x.to(dtype) @ lin.weight.t().to(dtype)
    return y if lin.bias is None else y + lin.bias.to(dtype)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU (exact erf, or the tanh form): ``F.gelu`` in f32; in a low
    dtype the JAX package's ``nn.gelu`` formula, one rounded op at a time
    (0.5 x erfc(-x sqrt(1/2)), or x 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715
    x^3))), its constants rounded to the dtype), as XLA evaluates it."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh" if approximate else "none")
    c = lambda v: _rounded(v, x.dtype)
    if approximate:
        cube = c(0.044715) * (x * x * x)
        return x * (c(0.5) * (c(1.0) + torch.tanh(c(math.sqrt(2 / math.pi)) * (x + cube))))
    return c(0.5) * x * torch.erfc(-x * c(math.sqrt(0.5)))


def _rounded(v: float, dtype: torch.dtype) -> float:
    """The Python float of v rounded to ``dtype`` (computed on the host: a
    device tensor would be a copy, which a CUDA graph capture refuses)."""
    return float(torch.tensor(v, dtype=dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid`` in f32; in a low dtype 1 / (1 + exp(-x)), one
    rounded op at a time, as XLA evaluates the JAX package's sigmoid."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def dropout(x: torch.Tensor, p: float, gen: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with masks drawn from ``gen`` (keep w.p. 1 - p)."""
    if p == 0.0:
        return x
    if gen is None:
        raise ValueError("dropout in train mode needs a torch.Generator (dropout_gen)")
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return x * keep / (1.0 - p)


def bf16_mask_dropout(x: torch.Tensor, p: float, gen: torch.Generator | None) -> torch.Tensor:
    """The JAX package's ``_bf16_mask_dropout`` (``dropout_impl="bf16mask"``):
    x times a bf16 mask of 0 or 1 / (1 - p), the scale rounded to bf16, so
    that the saved operand is 2 bytes an element. The same distribution
    as ``dropout`` (keep w.p. 1 - p), drawn from ``gen``; a bf16 x stays
    bf16, an f32 x f32."""
    if p == 0.0:
        return x
    if gen is None:
        raise ValueError("dropout in train mode needs a torch.Generator (dropout_gen)")
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return x * (keep.to(torch.bfloat16) * _rounded(1.0 / (1.0 - p), torch.bfloat16))


def time_encoder_spectrum(time_dim: int) -> np.ndarray:
    """The fixed 1/10^linspace(0,9,d) frequency init, shape (1, d)."""
    return (1.0 / 10 ** np.linspace(0, 9, time_dim, dtype=np.float32)).reshape(1, time_dim)


class TimeEncoder(nn.Module):
    """Cosine time features phi(t) = cos(w * t + b) with exact ``cos``."""

    def __init__(self, time_dim: int, trainable: bool = True):
        super().__init__()
        spectrum = torch.from_numpy(time_encoder_spectrum(time_dim))
        self.w = nn.Parameter(spectrum, requires_grad=trainable)
        self.b = nn.Parameter(torch.zeros(time_dim), requires_grad=trainable)

    def forward(self, timestamps: torch.Tensor) -> torch.Tensor:
        """(...,) times -> (..., time_dim) features."""
        return torch.cos(timestamps[..., None] * self.w[0] + self.b)


class _FusedCell(nn.Module):
    """A recurrent cell's parameters in the JAX package's layout and names:
    wi (D, G H), wh (H, G H), bi and bh (G H,) for G gates, each drawn from
    U(+-1/sqrt(H)) from ``gen``, in that order. They are not named
    ``kernel``, so ``transfer`` copies them as they are (nothing is
    transposed)."""

    def __init__(self, input_dim: int, hidden_dim: int, gen: torch.Generator, gates: int):
        super().__init__()
        bound = hidden_dim**-0.5
        self.hidden_dim = hidden_dim
        self.wi = nn.Parameter(_uniform((input_dim, gates * hidden_dim), bound, gen))
        self.wh = nn.Parameter(_uniform((hidden_dim, gates * hidden_dim), bound, gen))
        self.bi = nn.Parameter(_uniform((gates * hidden_dim,), bound, gen))
        self.bh = nn.Parameter(_uniform((gates * hidden_dim,), bound, gen))


class FusedGRUCell(_FusedCell):
    """torch ``nn.GRUCell``'s math (counterpart of the JAX package's
    ``FusedGRUCell``), gate order [r | z | n]:

        r = sigmoid(x Wi_r + bi_r + h Wh_r + bh_r)
        z = sigmoid(x Wi_z + bi_z + h Wh_z + bh_z)
        n = tanh(x Wi_n + bi_n + r * (h Wh_n + bh_n))
        h' = (1 - z) n + z h

    Both bias vectors stay: bh_n sits inside the reset gate's product."""

    def __init__(self, input_dim: int, hidden_dim: int, gen: torch.Generator):
        super().__init__(input_dim, hidden_dim, gen, gates=3)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """h (..., H), x (..., D) -> h' (..., H)."""
        hd = self.hidden_dim
        gi = x @ self.wi + self.bi
        gh = h @ self.wh + self.bh
        r = torch.sigmoid(gi[..., :hd] + gh[..., :hd])
        z = torch.sigmoid(gi[..., hd : 2 * hd] + gh[..., hd : 2 * hd])
        n = torch.tanh(gi[..., 2 * hd :] + r * gh[..., 2 * hd :])
        return (1.0 - z) * n + z * h


class FusedRNNCell(_FusedCell):
    """torch ``nn.RNNCell`` (tanh): h' = tanh(x Wi + bi + h Wh + bh)."""

    def __init__(self, input_dim: int, hidden_dim: int, gen: torch.Generator):
        super().__init__(input_dim, hidden_dim, gen, gates=1)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x @ self.wi + self.bi + h @ self.wh + self.bh)


class MergeLayer(nn.Module):
    """concat(x1, x2) -> Linear -> ReLU -> Linear."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, gen: torch.Generator):
        super().__init__()
        self.fc1 = linear(input_dim, hidden_dim, gen)
        self.fc2 = linear(hidden_dim, output_dim, gen)

    def forward(self, input_1: torch.Tensor, input_2: torch.Tensor) -> torch.Tensor:
        h = self.fc1(torch.cat([input_1, input_2], dim=-1))
        return self.fc2(torch.relu(h))


class MLPClassifier(nn.Module):
    """Node classification's head: input -> 80 -> 10 -> 1, ReLU, dropout
    after each hidden layer (in train mode, masks from ``dropout_gen``)."""

    def __init__(self, input_dim: int, gen: torch.Generator, dropout: float = 0.1):
        super().__init__()
        self.fc1 = linear(input_dim, 80, gen)
        self.fc2 = linear(80, 10, gen)
        self.fc3 = linear(10, 1, gen)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, dropout_gen: torch.Generator | None = None):
        p = self.dropout if self.training else 0.0
        x = dropout(torch.relu(self.fc1(x)), p, dropout_gen)
        x = dropout(torch.relu(self.fc2(x)), p, dropout_gen)
        return self.fc3(x)


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

    ``compute_dtype`` (bfloat16: the JAX module's ``dtype``) rounds as the
    JAX module does: the query, its projection, the kv rows, key and value
    and the attention-weighted sum in bf16 (logits and softmax in f32), then
    residual_fc in bf16 and the LayerNorm in f32. The kernels take the
    query projection in f32, as the JAX module casts it, and keep their f32
    math (the JAX kernels round their operands to bf16 inside).
    """

    def __init__(
        self, node_dim: int, edge_dim: int, time_dim: int, num_heads: int, dropout: float,
        gen: torch.Generator, use_pallas: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
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
        heads, cd = self.num_heads, self.compute_dtype
        query = residual = torch.cat([node_features, node_time_features], dim=-1).to(cd)
        q = project(self.query_projection, query, cd)
        m, k = neighbor_mask.shape
        mask = neighbor_mask.to(torch.float32)
        keep = _keep_mask((m, heads, k), p, dropout_gen, q.device)
        wk, wv = self.key_projection.weight.t(), self.value_projection.weight.t()
        scores = None
        if gathered is not None:
            feat_n, feat_e, dt, (tw, tb) = gathered
            f = ops.gathered_attention if use_kernels else ops.gathered_attention_plain
            out = f(q.float(), feat_n.detach(), feat_e.detach(), dt, mask, keep,
                    (tw.reshape(-1), tb), (wk, wv), heads)
        elif window is not None:
            starts, dt, table, (tw, tb) = window
            f = ops.window_attention if use_kernels else ops.window_attention_plain
            out = f(q.float(), starts, dt, mask, keep, table.detach(), tw.reshape(-1), tb,
                    (wk, wv), heads)
        elif time_fused is not None:
            # key = feat @ Wk[:Df] (in cd) + Phi(dt) @ Wk[Df:] (f32), rounded to
            # cd: the JAX module's order
            dt, (tw, tb) = time_fused
            feat = torch.cat([neighbor_node_features, neighbor_edge_features], dim=-1)
            d_feat = feat.shape[-1]
            feat = feat.reshape(m * k, d_feat).to(cd)
            proj = ops.phi_projection if use_kernels else ops.phi_projection_plain
            dt, tw = dt.reshape(-1), tw.reshape(-1)
            key = ((feat @ wk[:d_feat].to(cd)).float() + proj(dt, tw, tb, wk[d_feat:])).to(cd)
            val = ((feat @ wv[:d_feat].to(cd)).float() + proj(dt, tw, tb, wv[d_feat:])).to(cd)
            out, scores = self._attend(q, key.view(m, k, -1), val.view(m, k, -1), neighbor_mask,
                                       keep)
        elif self.use_pallas:
            f = ops.temporal_attention if use_kernels else ops.temporal_attention_plain
            out, scores = f(q.float(), neighbor_node_features.float(),
                            neighbor_edge_features.float(), neighbor_time_features.float(),
                            mask, keep, wk, wv, heads)
        else:
            kv = torch.cat(
                [neighbor_node_features, neighbor_edge_features, neighbor_time_features], dim=-1
            ).to(cd)
            out, scores = self._attend(q, project(self.key_projection, kv, cd),
                                       project(self.value_projection, kv, cd), neighbor_mask, keep)
        out = dropout(project(self.residual_fc, out.to(cd), cd), p, dropout_gen)
        return self.layer_norm((out + residual).float()), scores

    def _attend(self, q, key, val, neighbor_mask, keep):
        """The plain single-query attention: f32 as ``ops._attention.attend``
        computes it, a low compute dtype as the JAX module does."""
        if self.compute_dtype == torch.float32:
            return attend(q, key, val, neighbor_mask.to(torch.float32), keep, self.num_heads)
        return _attend_lowp(q, key, val, neighbor_mask, keep, self.num_heads)


def _attend_lowp(q, key, val, mask, keep, num_heads: int):
    """Single-query attention as the JAX module computes it in a low
    compute dtype: q (M, Dq), key and val (M, K, Dq) in that dtype; logits
    in it, then f32 for the scale, the -1e10 pad logit and the softmax;
    the scores times ``keep`` (M, H, K); their weighted sum of val in the
    low dtype. -> (out (M, Dq), scores (M, H, K) f32)."""
    m, k, dq = key.shape
    hd = dq // num_heads
    kh = key.view(m, k, num_heads, hd).transpose(1, 2)  # (M, H, K, hd)
    logits = torch.matmul(q.view(m, num_heads, 1, hd), kh.transpose(-1, -2)).float() * hd**-0.5
    logits = torch.where(mask[:, None, None, :], logits, NEG)
    scores = torch.softmax(logits, dim=-1) * keep[:, :, None, :]  # (M, H, 1, K)
    out = torch.matmul(scores.to(key.dtype), val.view(m, k, num_heads, hd).transpose(1, 2))
    return out.reshape(m, dq), scores[:, :, 0, :]


class TransformerEncoder(nn.Module):
    """Post-LN transformer block with optional cross-attention.

    Counterpart of ``dyglib_tpu/nn/modules.py::TransformerEncoder`` (f32),
    with its parameter names: ``q_proj``, ``k_proj`` and ``v_proj``
    (xavier-uniform, zero bias), ``out_proj`` (torch's default Linear
    weight, zero bias), ``norm1``, ``ffn1`` (d -> 4d), ``ffn2`` and
    ``norm2``:

        x   = norm1(query + dropout(out_proj(attention(query, key, value))))
        out = norm2(x + dropout(ffn2(dropout(relu(ffn1(x))))))

    Padded keys (``mask`` False) get the logit -1e10, so an all-padded row
    attends uniformly instead of giving NaN. Dropout (train mode) draws
    from ``dropout_gen``. DyGFormer's pre-LN block is another module
    (``models/dygformer.py::PreLNTransformerEncoder``). ``compute_dtype``
    (the JAX module's ``dtype``): the projections, the attention's products
    and the FFN in that dtype, logits, softmax, residuals and LayerNorms in
    f32, as the JAX module rounds them.
    """

    def __init__(self, attention_dim: int, num_heads: int, dropout: float, gen: torch.Generator,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        d = attention_dim
        if d % num_heads:
            raise ValueError(f"attention width {d} does not split into {num_heads} heads")
        self.num_heads = num_heads
        self.dropout = dropout
        self.q_proj = linear(d, d, gen, xavier=True, zero_bias=True)
        self.k_proj = linear(d, d, gen, xavier=True, zero_bias=True)
        self.v_proj = linear(d, d, gen, xavier=True, zero_bias=True)
        self.out_proj = linear(d, d, gen, zero_bias=True)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.ffn1 = linear(d, 4 * d, gen)
        self.ffn2 = linear(4 * d, d, gen)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(
        self,
        query: torch.Tensor,  # (B, Tq, D)
        key: torch.Tensor | None = None,  # (B, Tk, D); None: self-attention
        value: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,  # (B, Tk) bool, True = keep
        dropout_gen: torch.Generator | None = None,
    ) -> torch.Tensor:
        if (key is None) != (value is None):
            raise ValueError("pass both key and value, or neither")
        if key is None:
            key = value = query
        p = self.dropout if self.training else 0.0
        drop = lambda y: dropout(y, p, dropout_gen)
        b, tq, d = query.shape
        tk, heads, cd = key.shape[1], self.num_heads, self.compute_dtype
        hd = d // heads
        q = project(self.q_proj, query, cd).view(b, tq, heads, hd)
        k = project(self.k_proj, key, cd).view(b, tk, heads, hd)
        v = project(self.v_proj, value, cd).view(b, tk, heads, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
        if mask is not None:
            attn = torch.where(mask[:, None, None, :], attn, -1e10)
        scores = drop(torch.softmax(attn, dim=-1))
        hidden = torch.einsum("bhqk,bkhd->bqhd", scores.to(cd), v).reshape(b, tq, d)
        x = self.norm1(query + drop(project(self.out_proj, hidden, cd).float()))
        ffn = project(self.ffn2, drop(torch.relu(project(self.ffn1, x, cd))), cd).float()
        return self.norm2(x + drop(ffn))
