"""What the four TGAT attention kernels share: their plain math, forward and
backward, and their wrappers' checks.

Single-query temporal attention (``nn/modules.py::TemporalMultiHeadAttention``):
one projected query row q3 (heads flattened) per query attends over its K
neighbor rows ``kv = [nbr || edge || Phi(dt)]``,

    key = kv @ Wk,  val = kv @ Wv                   (R = M * K rows)
    logit[h, j] = (q3_h . key_h[j]) * hd**-0.5,  -1e10 where mask[j] == 0
    score[h] = softmax(logit[h]) * keep[h]          (keep: dropout, pre-scaled)
    out_h = sum_j score[h, j] * val_h[j]

The pad logit is -1e10, not -inf, so an all-padded row attends uniformly
instead of giving NaN. The CUDA kernels never form key or val: the forward
(``csrc/attention_core.cuh``) takes the logits against qk = Wk_h q3_h and
out_h = (sum_j w kv_j) Wv_h, and the backward (``csrc/attention_bwd.cuh``)
is reassociated the same way. Each stages one query's K kv rows in one
block's shared memory, which is all that bounds K.

The plain backward (``attend_backward``, ``project_backward``) is the math
of the JAX ``_bwd_kernel``s (``dyglib_tpu/ops/pallas/temporal_attention.py``
:120-157): with g the output's cotangent and s the softmax before keep,

    ds_d = g_h . val_h[j] + dscores,   dval = (s * keep) g_h
    ds = ds_d * keep,   dlog = s * (ds - sum_j ds * s), 0 at pads, * scale
    dq3_h = sum_j dlog key_h[j],   dkey = dlog q3_h
    dkv = dkey @ Wk^T + dval @ Wv^T,  dWk = kv^T dkey,  dWv = kv^T dval

``abs_terms=True`` runs the same formulas on the operands' magnitudes, with
the softmax's subtraction made an addition: each output entry is then the
sum of the |terms| its sums add, the scale to which the card's checks hold
a backward kernel's rounding (sums taken in another order).
"""
from __future__ import annotations

import torch

from . import _build, _plan

NEG = -1e10  # pad logit
# shared memory one block may use on the H100: a query's block stages its K
# kv rows and its per-head rows there (csrc/attention_core.cuh,
# csrc/attention_bwd.cuh)
MAX_SHARED_BYTES = 227 * 1024


def rounded(compute_dtype: torch.dtype, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The operands as f32 tensors holding ``compute_dtype`` values (bf16:
    the TPU kernels' operand rounding, with f32 accumulation)."""
    if compute_dtype == torch.float32:
        return xs
    return tuple(x.to(compute_dtype).float() for x in xs)


def project_kv(kv, wk, wv, compute_dtype=torch.float32):
    """(key, val), each (R, Dq), of the kv rows (R, Dkv)."""
    kv, wk, wv = rounded(compute_dtype, kv, wk, wv)
    return kv @ wk, kv @ wv


def _softmax_scores(q3, key, mask, num_heads):
    """Softmax over the K neighbors before keep, (M, H, K)."""
    m, k, dq = key.shape
    hd = dq // num_heads
    logits = (q3.view(m, 1, num_heads, hd) * key.view(m, k, num_heads, hd)).sum(-1)
    logits = torch.where(mask[..., None] > 0, logits * hd**-0.5, NEG)  # (M, K, H)
    return torch.softmax(logits, dim=1).transpose(1, 2)


def attend(q3, key, val, mask, keep, num_heads: int):
    """q3 (M, Dq); key, val (M, K, Dq); mask (M, K); keep (M, H, K) ->
    (out (M, Dq), scores (M, H, K) after the keep multiply)."""
    m, k, dq = key.shape
    hd = dq // num_heads
    scores = _softmax_scores(q3, key, mask, num_heads) * keep  # (M, H, K)
    out = torch.einsum("mhk,mkhd->mhd", scores, val.view(m, k, num_heads, hd))
    return out.reshape(m, dq), scores


def attend_backward(q3, key, val, mask, keep, dout, dscores, num_heads: int, terms_of=None):
    """The explicit backward of ``attend``: dout (M, Dq) and dscores (M, H, K)
    (None: zeros) -> (dq3 (M, Dq), dkey (M, K, Dq), dval (M, K, Dq)).

    ``terms_of=(key_abs, val_abs)``, the sums of |terms| of key and val
    (``|kv| @ |W|``): the same outputs' sums of |terms| instead."""
    m, k, dq = key.shape
    hd = dq // num_heads
    s = _softmax_scores(q3, key, mask, num_heads)  # (M, H, K)
    if terms_of is not None:
        q3, dout = q3.abs(), dout.abs()
        key, val = terms_of
        dscores = None if dscores is None else dscores.abs()
    gh = dout.view(m, num_heads, hd)
    ds = torch.einsum("mhd,mkhd->mhk", gh, val.view(m, k, num_heads, hd))
    if dscores is not None:
        ds = ds + dscores
    ds = ds * keep
    total = (ds * s).sum(-1, keepdim=True)
    dlog = s * (ds - total if terms_of is None else ds + total)
    dlog = torch.where(mask[:, None, :] > 0, dlog, 0.0) * hd**-0.5  # (M, H, K)
    dq3 = torch.einsum("mhk,mkhd->mhd", dlog, key.view(m, k, num_heads, hd)).reshape(m, dq)
    dkey = torch.einsum("mhk,mhd->mkhd", dlog, q3.view(m, num_heads, hd)).reshape(m, k, dq)
    dval = torch.einsum("mhk,mhd->mkhd", s * keep, gh).reshape(m, k, dq)
    return dq3, dkey, dval


def attention_backward(q3, kv, mask, keep, wk, wv, dout, dscores, num_heads: int,
                       kv_cols: slice = slice(None), compute_dtype=torch.float32,
                       abs_terms: bool = False):
    """The whole plain backward on the kv rows (M * K, Dkv) -> (dq3,
    dkv[:, kv_cols], dWk, dWv); ``abs_terms``: their sums of |terms|."""
    m, k = mask.shape
    key, val = project_kv(kv, wk, wv, compute_dtype)
    terms_of = None
    if abs_terms:
        terms_of = tuple(t.view(m, k, -1) for t in project_kv(kv.abs(), wk.abs(), wv.abs()))
    dq3, dkey, dval = attend_backward(q3, key.view(m, k, -1), val.view(m, k, -1), mask, keep,
                                      dout, dscores, num_heads, terms_of)
    dkv, dwk, dwv = project_backward(kv, wk, wv, dkey.reshape(m * k, -1),
                                     dval.reshape(m * k, -1), kv_cols, compute_dtype, abs_terms)
    return dq3, dkv, dwk, dwv


def project_backward(kv, wk, wv, dkey, dval, kv_cols: slice = slice(None),
                     compute_dtype=torch.float32, abs_terms: bool = False):
    """The projections' backward on the kv rows (R, Dkv) with dkey, dval
    (R, Dq) -> (dkv[:, kv_cols], dWk, dWv), each product on
    ``compute_dtype`` operands with f32 accumulation (the JAX kernels')."""
    kv, wk, wv, dkey, dval = rounded(compute_dtype, kv, wk, wv, dkey, dval)
    if abs_terms:
        kv, wk, wv, dkey, dval = kv.abs(), wk.abs(), wv.abs(), dkey.abs(), dval.abs()
    dkv = dkey @ wk[kv_cols].t() + dval @ wv[kv_cols].t()
    return dkv, kv.t() @ dkey, kv.t() @ dval


def time_param_grads(dphi, dt, tw, tb, abs_terms: bool = False):
    """(dtw, dtb) of Phi = cos(dt * tw + tb) from dPhi (R, Dt) and dt (R,)."""
    msin = -torch.sin(dt[:, None] * tw + tb)
    if abs_terms:
        dphi, msin, dt = dphi.abs(), msin.abs(), dt.abs()
    common = dphi * msin
    return (common * dt[:, None]).sum(0), common.sum(0)


def check_attention(q3, mask, keep, wk, wv, kv_dim: int, num_heads: int):
    """Check the operands every attention kernel takes; returns (m, k, dq,
    (wk_sk, wk_sn), (wv_sk, wv_sn))."""
    m, dq = q3.shape
    k = mask.shape[-1]
    if k < 1:
        raise ValueError(f"{k} neighbors per query; the kernels take at least 1")
    if num_heads < 1 or dq % num_heads:
        raise ValueError(f"query width {dq} does not split into {num_heads} heads")
    check_shared_memory(k, kv_dim, num_heads, backward=False)
    f32, dev = torch.float32, q3.device
    _build.require(q3, "q3", f32, (m, dq), dev)
    _build.require(mask, "mask", f32, (m, k), dev)
    _build.require(keep, "keep", f32, (m, num_heads, k), dev)
    if m * k >= 2**31 or m * num_heads * kv_dim >= 2**31:
        raise ValueError(
            f"{m * k} kv rows, {m * num_heads * kv_dim} backward scratch entries; the kernels "
            "index with int32"
        )
    wk_s = _build.require_weight(wk, "wk", f32, (kv_dim, dq), dev)
    wv_s = _build.require_weight(wv, "wv", f32, (kv_dim, dq), dev)
    return m, k, dq, wk_s, wv_s


def check_shared_memory(k: int, kv_dim: int, num_heads: int, backward: bool,
                        sin_cols: int = 0) -> None:
    """Raise unless one query's block fits the shared memory of a block:
    its K kv rows, and per head the query's qk (the backward: qk and gv)
    and its K logits (the backward: four such rows); the backward of the
    gathered and window kernels also holds -sin of its K x ``sin_cols``
    Phi arguments (``csrc/attention_bwd.cuh::attention_bwd_smem_floats``)."""
    per_head = 2 * kv_dim + 4 * k if backward else kv_dim + k
    smem = 4 * (k * kv_dim + num_heads * per_head + (k * sin_cols if backward else 0))
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"{k} kv rows of {kv_dim} and {num_heads} heads need {smem} bytes of shared "
            f"memory in the {'backward' if backward else 'forward'} kernel; a block takes at "
            f"most {MAX_SHARED_BYTES}"
        )


def head_scale(dq: int, num_heads: int) -> float:
    return (dq // num_heads) ** -0.5


def forward_scratch(m: int, kv_dim: int, num_heads: int, device) -> torch.Tensor:
    """The forward kernels' scratch: qk and Av, (2, M, H, Dkv)."""
    return torch.empty((2, m, num_heads, kv_dim), dtype=torch.float32, device=device)


def _sms(device) -> int:
    # a CPU caller runs the plain version and launches nothing: it plans for an H100
    device = torch.device(device)
    return _plan.sm_count(device) if device.type == "cuda" else _plan.H100_SMS


def forward_plan(m: int, kv_dim: int, dq: int, num_heads: int, device) -> tuple[int, int]:
    """The rows a block of the forward's head_project and head_combine
    takes on ``device`` (``_plan.head_plan``)."""
    return _plan.head_plan(m, kv_dim, dq, num_heads, _sms(device), backward=False)


def backward_scratch(m: int, k: int, kv_dim: int, dq: int, num_heads: int, device,
                     sin_cols: int = 0):
    """The backward kernels' scratch: qk, gv, ak, av (4, M, H, Dkv) and the
    weight gradients' per-chunk partial sums (chunks, Dkv, Dq); returns
    (scratch, partial, plan), the plan ``_plan.head_plan``'s (project,
    combine and weight-gradient rows, chunk rows). Raises if a query's kv
    rows (and its ``sin_cols`` Phi columns' sines) do not fit one block's
    shared memory."""
    check_shared_memory(k, kv_dim, num_heads, backward=True, sin_cols=sin_cols)
    plan = _plan.head_plan(m, kv_dim, dq, num_heads, _sms(device), backward=True)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)
    return new(4, m, num_heads, kv_dim), new(max(1, -(-m // plan[-1])), kv_dim, dq), plan
