"""What the four TGAT attention kernels share: their plain math and their
wrappers' checks.

Single-query temporal attention (``nn/modules.py::TemporalMultiHeadAttention``):
one projected query row q3 (heads flattened) per query attends over its K
neighbor rows ``kv = [nbr || edge || Phi(dt)]``,

    key = kv @ Wk,  val = kv @ Wv                   (R = M * K rows)
    logit[h, j] = (q3_h . key_h[j]) * hd**-0.5,  -1e10 where mask[j] == 0
    score[h] = softmax(logit[h]) * keep[h]          (keep: dropout, pre-scaled)
    out_h = sum_j score[h, j] * val_h[j]

The pad logit is -1e10, not -inf, so an all-padded row attends uniformly
instead of giving NaN. The CUDA kernels (``csrc/attention_core.cuh``) keep
key and val out of device memory.
"""
from __future__ import annotations

import torch

from . import _build

NEG = -1e10  # pad logit
# queries per kernel block are TILE_ROWS // K, so K may not exceed one tile
MAX_NEIGHBORS = _build.TILE_ROWS
# the kernels keep every head's logits of a block in shared memory
MAX_HEADS = 64


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


def attend(q3, key, val, mask, keep, num_heads: int):
    """q3 (M, Dq); key, val (M, K, Dq); mask (M, K); keep (M, H, K) ->
    (out (M, Dq), scores (M, H, K) after the keep multiply)."""
    m, k, dq = key.shape
    hd = dq // num_heads
    logits = (q3.view(m, 1, num_heads, hd) * key.view(m, k, num_heads, hd)).sum(-1)
    logits = torch.where(mask[..., None] > 0, logits * hd**-0.5, NEG)  # (M, K, H)
    scores = torch.softmax(logits, dim=1).transpose(1, 2) * keep  # (M, H, K)
    out = torch.einsum("mhk,mkhd->mhd", scores, val.view(m, k, num_heads, hd))
    return out.reshape(m, dq), scores


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would need a backward this kernel does not have.

    The CUDA wrappers write their outputs through ctypes, so a result would
    carry no ``grad_fn`` and its inputs would silently get no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward kernel yet (TGAT training, ROADMAP.md slice 4): "
            "call it under torch.no_grad() or torch.inference_mode(), or on CPU tensors"
        )


def check_attention(q3, mask, keep, wk, wv, kv_dim: int, num_heads: int):
    """Check the operands every attention kernel takes; returns (m, k, dq,
    (wk_sk, wk_sn), (wv_sk, wv_sn))."""
    m, dq = q3.shape
    k = mask.shape[-1]
    if not 1 <= k <= MAX_NEIGHBORS:
        raise ValueError(f"{k} neighbors per query; the kernels take 1 to {MAX_NEIGHBORS}")
    if not 1 <= num_heads <= MAX_HEADS or dq % num_heads:
        raise ValueError(f"query width {dq} does not split into {num_heads} heads (at most {MAX_HEADS})")
    f32, dev = torch.float32, q3.device
    _build.require(q3, "q3", f32, (m, dq), dev)
    _build.require(mask, "mask", f32, (m, k), dev)
    _build.require(keep, "keep", f32, (m, num_heads, k), dev)
    if m * k >= 2**31:
        raise ValueError(f"{m * k} kv rows; the kernels index with int32")
    wk_s = _build.require_weight(wk, "wk", f32, (kv_dim, dq), dev)
    wv_s = _build.require_weight(wv, "wv", f32, (kv_dim, dq), dev)
    return m, k, dq, wk_s, wv_s


def head_scale(dq: int, num_heads: int) -> float:
    return (dq // num_heads) ** -0.5
