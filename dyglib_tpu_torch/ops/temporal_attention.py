"""Fused single-query temporal attention for TGAT (CUDA, ``csrc/temporal_attention.cu``).

    kv = [nbr || edge || phi]  (M, K, Dn + De + Dt)
    key = kv @ wk, val = kv @ wv, then masked softmax, keep, weighted sum
    (``ops/_attention.py``)

Replaces ``dyglib_tpu/ops/pallas/temporal_attention.py::temporal_attention``,
its forward ``_fwd_kernel``. TGAT runs it at layer 2, whose kv rows are
layer-1 embeddings. One block takes TILE_ROWS // K queries (3 at K = 20, 60
of 64 rows): the (rows, Dq) key and val tiles come from the shared f32 tile
of ``csrc/tiled_gemm.cuh``, with an A loader that reads the three column
ranges of kv from their own tensors (the concatenation never exists), and
are consumed in shared memory: key column tiles into per-head logits,
val column tiles into the weighted sum. Neither reaches device memory.
Outputs: out (M, Dq) and the post-keep scores (M, H, K).

No backward kernel yet: on CUDA tensors the wrapper raises in grad mode
(``_attention.refuse_grad``); on CPU tensors it runs the plain version,
which autograd differentiates.

Bound on one H100 at the TGAT evaluation batch (B = 200 triple, M = 600,
K = 20, Dn = De = 172, Dt = 100, Dq = 272, H = 2), f32 on CUDA cores:
the two projections are 2 * 12,000 * 444 * 272 * 2 = 5.8 G operations
-> 0.087 ms at 67 T/s; 21.3 MB of kv read -> 6.4 us. Bound by operations.

What the simple design leaves on the table: each block stages its kv tile
once per 64-column tile of key and of val (10 times at Dq = 272, the last
tile 16 wide); f32 FMAs on CUDA cores where TF32 or bf16 tensor cores would
lift the bound 7-15x.
"""
from __future__ import annotations

import torch

from . import _attention, _build

_NAME = "temporal_attention"
_ARGTYPES = (
    [_build.P] * 7 + [_build.I] * 2 + [_build.P] + [_build.I] * 2 + [_build.P] * 2
    + [_build.I] * 7 + [_build.F, _build.P]
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


def temporal_attention(q3, nbr, edge, phi, mask, keep, wk, wv, num_heads: int):
    """As ``temporal_attention_plain`` (f32). ``wk`` and ``wv`` may be
    row-major or the transpose of nn.Linear's (Dq, Dkv) weight. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if q3.device.type == "cpu":
        return temporal_attention_plain(q3, nbr, edge, phi, mask, keep, wk, wv, num_heads)
    if q3.device.type != "cuda":
        raise ValueError(f"temporal_attention: unsupported device {q3.device}")
    _attention.refuse_grad(_NAME, q3, nbr, edge, phi, mask, keep, wk, wv)
    dn, de, dt = nbr.shape[-1], edge.shape[-1], phi.shape[-1]
    m, k, dq, (wk_sk, wk_sn), (wv_sk, wv_sn) = _attention.check_attention(
        q3, mask, keep, wk, wv, dn + de + dt, num_heads
    )
    f32, dev = torch.float32, q3.device
    for t, name, d in ((nbr, "nbr", dn), (edge, "edge", de), (phi, "phi", dt)):
        _build.require(t, name, f32, (m, k, d), dev)
    out = torch.empty((m, dq), dtype=f32, device=dev)
    scores = torch.empty((m, num_heads, k), dtype=f32, device=dev)
    lib = _build.load(_NAME, "temporal_attention_forward", _ARGTYPES)
    rc = lib.temporal_attention_forward(
        q3.data_ptr(), nbr.data_ptr(), edge.data_ptr(), phi.data_ptr(), mask.data_ptr(),
        keep.data_ptr(), wk.data_ptr(), wk_sk, wk_sn, wv.data_ptr(), wv_sk, wv_sn,
        out.data_ptr(), scores.data_ptr(), m, k, dn, de, dt, dq, num_heads,
        _attention.head_scale(dq, num_heads), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    temporal_attention.launches += 1
    return out, scores


temporal_attention.launches = 0
