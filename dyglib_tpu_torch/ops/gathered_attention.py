"""Post-gather fused temporal attention for TGAT (CUDA, ``csrc/gathered_attention.cu``).

    kv = [feat_n || feat_e || cos(dt * tw + tb)]  (M * K rows)
    then key, val, masked softmax, keep, weighted sum (``ops/_attention.py``)

Replaces ``dyglib_tpu/ops/pallas/gathered_attention.py::gathered_attention``,
its forward ``_fwd_kernel``. TGAT runs it at layer 1, whose kv rows are raw
feature rows gathered from the tables (pad rows are the zero id-0 rows, so
nothing is masked here). The node and edge rows arrive as two slabs and
Phi(dt) is computed in the tile's A loader: neither the (M * K, Dt) time
features, the (M * K, 444) concatenation nor key and val reach device
memory (``csrc/attention_core.cuh``). Phi's argument is rounded as
PyTorch's separate multiply and add round it, and the cosine is the
accurate ``cosf``: dt reaches ~2.6e6 on the wikipedia-scale stream.

No backward kernel yet: on CUDA tensors the wrapper raises in grad mode;
on CPU tensors it runs the plain version, which autograd differentiates.

Bounds on one H100 at the TGAT evaluation batch (B = 200 triple, K = 20,
Dn = De = 172, Dt = 100, Dq = 272), f32 on CUDA cores, operations against
67 T/s and bytes against 3.35 TB/s:
  * hop 1 (M = 12,000, 240,000 kv rows): 116 G operations -> 1.73 ms;
    330 MB of feature rows read -> 0.099 ms. Bound by operations.
  * hop 0 (M = 600): 5.8 G operations -> 0.087 ms.

What the simple design leaves on the table: each block stages its kv tile,
cosines included, once per 64-column tile of key and of val (10 times at
Dq = 272); f32 FMAs on CUDA cores where tensor cores would lift the bound
7-15x; the accurate cosf's slow path above |theta| ~ 1e5.
"""
from __future__ import annotations

import torch

from . import _attention, _build

_NAME = "gathered_attention"
_ARGTYPES = (
    [_build.P] * 9 + [_build.I] * 2 + [_build.P] + [_build.I] * 2 + [_build.P]
    + [_build.I] * 7 + [_build.F, _build.P]
)


def gathered_attention_plain(
    q3, feat_n, feat_e, dt, mask, keep, time_wb, wkv, num_heads: int,
    compute_dtype: torch.dtype = torch.float32,
):
    """Plain PyTorch version, with the JAX signature: q3 (M, Dq); feat_n
    (M*K, Dn), feat_e (M*K, De); dt, mask (M, K) f32; keep (M, H, K) f32;
    time_wb = (tw, tb), each (Dt,); wkv = (wk, wv), each (Dn+De+Dt, Dq)
    -> out (M, Dq).

    ``compute_dtype=torch.bfloat16`` rounds the projections' operands to
    bf16 and accumulates in f32, the math of the JAX oracle
    ``gathered_attention_reference``.
    """
    (tw, tb), (wk, wv) = time_wb, wkv
    m, k = dt.shape
    phi = torch.cos(dt.reshape(m * k, 1) * tw + tb)
    kv = torch.cat([feat_n, feat_e, phi], dim=-1)
    key, val = _attention.project_kv(kv, wk, wv, compute_dtype)
    out, _ = _attention.attend(q3, key.view(m, k, -1), val.view(m, k, -1), mask, keep, num_heads)
    return out


def gathered_attention(q3, feat_n, feat_e, dt, mask, keep, time_wb, wkv, num_heads: int):
    """As ``gathered_attention_plain`` (f32). The weights may be row-major
    or the transpose of nn.Linear's (Dq, Dkv) weight. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if q3.device.type == "cpu":
        return gathered_attention_plain(q3, feat_n, feat_e, dt, mask, keep, time_wb, wkv, num_heads)
    if q3.device.type != "cuda":
        raise ValueError(f"gathered_attention: unsupported device {q3.device}")
    (tw, tb), (wk, wv) = time_wb, wkv
    _attention.refuse_grad(_NAME, q3, feat_n, feat_e, dt, mask, keep, tw, tb, wk, wv)
    dn, de, dt_dim = feat_n.shape[-1], feat_e.shape[-1], tw.shape[-1]
    m, k, dq, (wk_sk, wk_sn), (wv_sk, wv_sn) = _attention.check_attention(
        q3, mask, keep, wk, wv, dn + de + dt_dim, num_heads
    )
    f32, dev = torch.float32, q3.device
    for t, name, shape in (
        (feat_n, "feat_n", (m * k, dn)), (feat_e, "feat_e", (m * k, de)), (dt, "dt", (m, k)),
        (tw, "tw", (dt_dim,)), (tb, "tb", (dt_dim,)),
    ):
        _build.require(t, name, f32, shape, dev)
    out = torch.empty((m, dq), dtype=f32, device=dev)
    lib = _build.load(_NAME, "gathered_attention_forward", _ARGTYPES)
    rc = lib.gathered_attention_forward(
        q3.data_ptr(), feat_n.data_ptr(), feat_e.data_ptr(), dt.data_ptr(), tw.data_ptr(),
        tb.data_ptr(), mask.data_ptr(), keep.data_ptr(), wk.data_ptr(), wk_sk, wk_sn,
        wv.data_ptr(), wv_sk, wv_sn, out.data_ptr(), m, k, dn, de, dt_dim, dq, num_heads,
        _attention.head_scale(dq, num_heads), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    gathered_attention.launches += 1
    return out


gathered_attention.launches = 0
