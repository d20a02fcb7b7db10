"""Window-gather fused temporal attention for TGAT (CUDA, ``csrc/window_attention.cu``).

    kv[m, j] = [table[starts[m] + j] * mask[m, j] || cos(dt[m, j] * tw + tb)]
    then key, val, masked softmax, keep, weighted sum (``ops/_attention.py``)

Replaces ``dyglib_tpu/ops/pallas/window_attention.py::window_attention``,
its forward ``_fwd_kernel`` (``_core``). Under the ``recent`` strategy a
query's K neighbors are one contiguous run of CSR entries, so their
[node || edge] rows are K consecutive rows of ``csr.feat_entry`` (packed
row-major, Dn + De columns). The tile's A loader reads exactly those rows,
times the mask (invalid rows become the zero rows the gather path reads),
and computes Phi(dt) with the rounding and accurate cosine of
``csrc/time_channel.cu``: the gathered features, the time features and key
and val never reach device memory (``csrc/attention_core.cuh``). None of
the JAX kernel's Mosaic aids is needed: no 8-row-aligned superset windows
(``_expand_to_aligned``), no keep rescale, no zero weight rows for a
128-lane table (``_pad_weight_rows``).

Callers keep every window inside the table: starts in [0, T - K]
(``TGAT.sample`` clamps the guard-offset starts as the JAX package does).

No backward kernel yet: on CUDA tensors the wrapper raises in grad mode;
on CPU tensors it runs the plain version, which autograd differentiates.

Bound on one H100 at the TGAT evaluation batch, layer 1, hop 1 (M =
12,000, K = 20, a 344-wide table, Dt = 100, Dq = 272), f32 on CUDA cores:
116 G operations -> 1.73 ms at 67 T/s; 330 MB of table rows read -> 0.099
ms. Bound by operations; hop 0 (M = 600) is 5.8 G -> 0.087 ms.

What the simple design leaves on the table: as ``ops/gathered_attention.py``
(kv staged once per 64-column tile of key and of val; CUDA-core f32).
"""
from __future__ import annotations

import torch

from . import _attention, _build

_NAME = "window_attention"
_ARGTYPES = (
    [_build.P] * 9 + [_build.I] * 2 + [_build.P] + [_build.I] * 2 + [_build.P]
    + [_build.I] * 6 + [_build.F, _build.P]
)


def window_attention_plain(
    q3, starts, dt, mask, keep, table, tw, tb, wkv, num_heads: int,
    compute_dtype: torch.dtype = torch.float32,
):
    """Plain PyTorch version, with the JAX signature: q3 (M, Dq); starts (M,)
    int32 window starts in the table; dt, mask (M, K) f32; keep (M, H, K)
    f32; table (T, Dn + De) f32; tw, tb (Dt,); wkv = (wk, wv), each
    (Dn+De+Dt, Dq) -> out (M, Dq).

    ``compute_dtype=torch.bfloat16`` rounds the projections' operands to
    bf16 and accumulates in f32, the math of the JAX oracle
    ``window_attention_reference``.
    """
    wk, wv = wkv
    m, k = dt.shape
    rows = starts.long()[:, None] + torch.arange(k, device=starts.device)
    feat = table[rows] * mask[..., None]
    phi = torch.cos(dt[..., None] * tw + tb)
    kv = torch.cat([feat, phi], dim=-1).reshape(m * k, -1)
    key, val = _attention.project_kv(kv, wk, wv, compute_dtype)
    out, _ = _attention.attend(q3, key.view(m, k, -1), val.view(m, k, -1), mask, keep, num_heads)
    return out


def window_attention(q3, starts, dt, mask, keep, table, tw, tb, wkv, num_heads: int):
    """As ``window_attention_plain`` (f32). The weights may be row-major or
    the transpose of nn.Linear's (Dq, Dkv) weight. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if q3.device.type == "cpu":
        return window_attention_plain(q3, starts, dt, mask, keep, table, tw, tb, wkv, num_heads)
    if q3.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q3.device}")
    wk, wv = wkv
    _attention.refuse_grad(_NAME, q3, dt, mask, keep, table, tw, tb, wk, wv)
    t_rows, width = table.shape
    dt_dim = tw.shape[-1]
    m, k, dq, (wk_sk, wk_sn), (wv_sk, wv_sn) = _attention.check_attention(
        q3, mask, keep, wk, wv, width + dt_dim, num_heads
    )
    if t_rows < k:
        raise ValueError(f"a table of {t_rows} rows holds no window of {k}")
    f32, dev = torch.float32, q3.device
    for t, name, dtype, shape in (
        (table, "table", f32, (t_rows, width)), (starts, "starts", torch.int32, (m,)),
        (dt, "dt", f32, (m, k)), (tw, "tw", f32, (dt_dim,)), (tb, "tb", f32, (dt_dim,)),
    ):
        _build.require(t, name, dtype, shape, dev)
    out = torch.empty((m, dq), dtype=f32, device=dev)
    lib = _build.load(_NAME, "window_attention_forward", _ARGTYPES)
    rc = lib.window_attention_forward(
        q3.data_ptr(), table.data_ptr(), starts.data_ptr(), dt.data_ptr(), tw.data_ptr(),
        tb.data_ptr(), mask.data_ptr(), keep.data_ptr(), wk.data_ptr(), wk_sk, wk_sn,
        wv.data_ptr(), wv_sk, wv_sn, out.data_ptr(), m, k, width, dt_dim, dq, num_heads,
        _attention.head_scale(dq, num_heads), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    window_attention.launches += 1
    return out


window_attention.launches = 0
