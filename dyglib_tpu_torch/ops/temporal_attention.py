"""Fused single-query temporal attention for TGAT (CUDA, ``csrc/temporal_attention.cu``).

    kv = [nbr || edge || phi]  (M, K, Dn + De + Dt)
    key = kv @ wk, val = kv @ wv, then masked softmax, keep, weighted sum
    (``ops/_attention.py``)

Replaces ``dyglib_tpu/ops/pallas/temporal_attention.py::temporal_attention``:
its forward ``_fwd_kernel`` and its backward ``_bwd_kernel``. TGAT runs it
at layer 2, whose kv rows are layer-1 embeddings. ``temporal_attention`` is
a ``torch.autograd.Function``: on CUDA tensors its forward and backward
launch the two kernels, on CPU tensors they run the plain forward and the
explicit plain backward below. Gradients flow to q3, nbr, edge, phi, wk and
wv, from the output and from the scores (a missing cotangent counts as
zeros, as JAX's does); mask and keep are data.

Forward (``csrc/attention_core.cuh``): never projects a kv row. Per query
and head, qk = Wk_h q3_h (the shared f32 tile of ``csrc/tiled_gemm.cuh``);
one block per query stages its K kv rows once (the three parts, each a
contiguous block, with 16-byte loads where the widths allow; the
concatenation never exists) and forms the logits kv . qk, the softmax, the
scores and Av = sum_j w kv_j; out_h = Av Wv_h (the tile again).

Backward (``csrc/attention_bwd.cuh``): never projects a kv row either. Per
query and head it forms qk = Wk_h q3_h and gv = Wv_h g_h, gets logits and
ds_d as kv . qk and kv . gv, and dq3, dWk, dWv from Ak = sum_j dlog kv_j and
Av = sum_j w kv_j; dkv = sum_h dlog qk + w gv gives dnbr, dedge, dphi.
Both directions are deterministic (fixed-order sums, no atomics). A query's
block holds its K rows in shared memory: that alone bounds K
(``_attention.check_shared_memory``).

Bounds on one H100 at the TGAT batch (B = 200 triple, M = 600, K = 20,
Dn = De = 172, Dt = 100, Dq = 272, H = 2), f32 on CUDA cores against
67 T/s, bytes against 3.35 TB/s:
  * forward: the logits against qk = Wk_h q3_h and out_h = (sum_j w kv_j)
    Wv_h: 0.33 G operations -> 0.005 ms; 21.3 MB of kv read -> 6.4 us.
  * backward: 0.85 G operations -> 0.013 ms; 21.3 MB of kv read and
    21.3 MB of dkv written -> 0.013 ms.

What the simple design leaves on the table: f32 FMAs on CUDA cores where
TF32 or bf16 tensor cores would lift the bound 7-15x; three launches for
the forward and seven for the backward, of small grids at M = 600; the
(2, M, H, Dkv) scratch of qk and Av goes through device memory.
"""
from __future__ import annotations

import torch

from . import _attention, _build

_NAME = "temporal_attention"
_ARGTYPES = (
    [_build.P] * 7 + [_build.I] * 2 + [_build.P] + [_build.I] * 2 + [_build.P] * 3
    + [_build.I] * 7 + [_build.F, _build.P]
)
_BWD_ARGTYPES = (
    [_build.P] * 7 + [_build.I] * 2 + [_build.P] + [_build.I] * 2 + [_build.P] * 10
    + [_build.I] * 7 + [_build.F, _build.I, _build.P]
)


def temporal_attention_plain(
    q3, nbr, edge, phi, mask, keep, wk, wv, num_heads: int,
    compute_dtype: torch.dtype = torch.float32,
):
    """Plain PyTorch version, with the JAX signature: q3 (M, Dq); nbr, edge,
    phi (M, K, D*); mask (M, K) f32; keep (M, H, K) f32; wk, wv (Dkv, Dq)
    -> (out (M, Dq), scores (M, H, K)).

    ``compute_dtype=torch.bfloat16`` rounds the projections' operands to
    bf16 and accumulates in f32, the math of the JAX kernel.
    """
    m, k, _ = nbr.shape
    kv = torch.cat([nbr, edge, phi], dim=-1).reshape(m * k, -1)
    key, val = _attention.project_kv(kv, wk, wv, compute_dtype)
    return _attention.attend(q3, key.view(m, k, -1), val.view(m, k, -1), mask, keep, num_heads)


def temporal_attention_backward_plain(
    q3, nbr, edge, phi, mask, keep, wk, wv, dout, dscores, num_heads: int,
    compute_dtype: torch.dtype = torch.float32, abs_terms: bool = False,
):
    """The explicit backward, with the JAX ``_ta_bwd``'s residuals and
    cotangents: dout (M, Dq), dscores (M, H, K) or None (zeros) -> (dq3,
    dnbr, dedge, dphi, dwk, dwv) (mask and keep get none).

    ``compute_dtype=torch.bfloat16`` rounds the JAX kernel's operands (kv,
    the weights, dkey and dval) to bf16 for its products; ``abs_terms``
    gives each output's sums of |terms| (``ops/_attention.py``).
    """
    m, k, dn = nbr.shape
    de = edge.shape[-1]
    kv = torch.cat([nbr, edge, phi], dim=-1).reshape(m * k, -1)
    dq3, dkv, dwk, dwv = _attention.attention_backward(
        q3, kv, mask, keep, wk, wv, dout, dscores, num_heads, compute_dtype=compute_dtype,
        abs_terms=abs_terms,
    )
    dkv = dkv.view(m, k, -1)
    return dq3, dkv[..., :dn], dkv[..., dn : dn + de], dkv[..., dn + de :], dwk, dwv


def _check(q3, nbr, edge, phi, mask, keep, wk, wv, num_heads):
    dn, de, dt = nbr.shape[-1], edge.shape[-1], phi.shape[-1]
    m, k, dq, wk_s, wv_s = _attention.check_attention(
        q3, mask, keep, wk, wv, dn + de + dt, num_heads
    )
    for t, name, d in ((nbr, "nbr", dn), (edge, "edge", de), (phi, "phi", dt)):
        _build.require(t, name, torch.float32, (m, k, d), q3.device)
    return m, k, dq, dn, de, dt, wk_s, wv_s


def _forward_kernel(q3, nbr, edge, phi, mask, keep, wk, wv, num_heads):
    m, k, dq, dn, de, dt, (wk_sk, wk_sn), (wv_sk, wv_sn) = _check(
        q3, nbr, edge, phi, mask, keep, wk, wv, num_heads
    )
    f32, dev = torch.float32, q3.device
    scratch = _attention.forward_scratch(m, dn + de + dt, num_heads, dev)
    out = torch.empty((m, dq), dtype=f32, device=dev)
    scores = torch.empty((m, num_heads, k), dtype=f32, device=dev)
    lib = _build.load(_NAME, "temporal_attention_forward", _ARGTYPES)
    rc = lib.temporal_attention_forward(
        q3.data_ptr(), nbr.data_ptr(), edge.data_ptr(), phi.data_ptr(), mask.data_ptr(),
        keep.data_ptr(), wk.data_ptr(), wk_sk, wk_sn, wv.data_ptr(), wv_sk, wv_sn,
        scratch.data_ptr(), out.data_ptr(), scores.data_ptr(), m, k, dn, de, dt, dq, num_heads,
        _attention.head_scale(dq, num_heads), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    _build.count_launch(temporal_attention)
    return out, scores


def temporal_attention_backward(q3, nbr, edge, phi, mask, keep, wk, wv, dout, dscores,
                                num_heads: int):
    """As ``temporal_attention_backward_plain`` (f32). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if q3.device.type == "cpu":
        return temporal_attention_backward_plain(
            q3, nbr, edge, phi, mask, keep, wk, wv, dout, dscores, num_heads
        )
    if q3.device.type != "cuda":
        raise ValueError(f"temporal_attention_backward: unsupported device {q3.device}")
    m, k, dq, dn, de, dt, (wk_sk, wk_sn), (wv_sk, wv_sn) = _check(
        q3, nbr, edge, phi, mask, keep, wk, wv, num_heads
    )
    f32, dev = torch.float32, q3.device
    _build.require(dout, "dout", f32, (m, dq), dev)
    if dscores is not None:
        _build.require(dscores, "dscores", f32, (m, num_heads, k), dev)
    kv_dim = dn + de + dt
    new = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    dq3, dnbr, dedge, dphi = new(m, dq), new(m, k, dn), new(m, k, de), new(m, k, dt)
    if m == 0:
        return dq3, dnbr, dedge, dphi, torch.zeros_like(wk), torch.zeros_like(wv)
    scratch, partial, chunk = _attention.backward_scratch(m, k, kv_dim, dq, num_heads, dev)
    dwk, dwv = new(kv_dim, dq), new(kv_dim, dq)
    lib = _build.load(_NAME, "temporal_attention_backward", _BWD_ARGTYPES)
    rc = lib.temporal_attention_backward(
        q3.data_ptr(), nbr.data_ptr(), edge.data_ptr(), phi.data_ptr(), mask.data_ptr(),
        keep.data_ptr(), wk.data_ptr(), wk_sk, wk_sn, wv.data_ptr(), wv_sk, wv_sn,
        dout.data_ptr(), 0 if dscores is None else dscores.data_ptr(), scratch.data_ptr(),
        partial.data_ptr(), dq3.data_ptr(), dnbr.data_ptr(), dedge.data_ptr(), dphi.data_ptr(),
        dwk.data_ptr(), dwv.data_ptr(), m, k, dn, de, dt, dq, num_heads,
        _attention.head_scale(dq, num_heads), chunk, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, f"{_NAME} backward")
    _build.count_launch(temporal_attention_backward)
    return dq3, dnbr, dedge, dphi, dwk, dwv


class _TemporalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q3, nbr, edge, phi, mask, keep, wk, wv, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q3, nbr, edge, phi, mask, keep, wk, wv)
        ctx.set_materialize_grads(False)
        if q3.device.type == "cpu":
            return temporal_attention_plain(q3, nbr, edge, phi, mask, keep, wk, wv, num_heads)
        return _forward_kernel(q3, nbr, edge, phi, mask, keep, wk, wv, num_heads)

    @staticmethod
    def backward(ctx, dout, dscores):
        q3, nbr, edge, phi, mask, keep, wk, wv = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(q3)
        dscores = None if dscores is None else dscores.contiguous()
        dq3, dnbr, dedge, dphi, dwk, dwv = temporal_attention_backward(
            q3, nbr, edge, phi, mask, keep, wk, wv, dout.contiguous(), dscores, ctx.num_heads
        )
        return dq3, dnbr, dedge, dphi, None, None, dwk, dwv, None


def temporal_attention(q3, nbr, edge, phi, mask, keep, wk, wv, num_heads: int):
    """As ``temporal_attention_plain`` (f32), differentiable in q3, nbr,
    edge, phi, wk and wv. ``wk`` and ``wv`` may be row-major or the
    transpose of nn.Linear's (Dq, Dkv) weight. CPU tensors take the plain
    versions; CUDA tensors launch the kernels."""
    if q3.device.type not in ("cpu", "cuda"):
        raise ValueError(f"temporal_attention: unsupported device {q3.device}")
    return _TemporalAttention.apply(q3, nbr, edge, phi, mask, keep, wk, wv, num_heads)


temporal_attention.launches = temporal_attention.captured = 0
temporal_attention_backward.launches = temporal_attention_backward.captured = 0
