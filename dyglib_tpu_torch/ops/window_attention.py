"""Window-gather fused temporal attention for TGAT (CUDA, ``csrc/window_attention.cu``).

    kv[m, j] = [table[starts[m] + j] * mask[m, j] || cos(dt[m, j] * tw + tb)]
    then key, val, masked softmax, keep, weighted sum (``ops/_attention.py``)

Replaces ``dyglib_tpu/ops/pallas/window_attention.py::window_attention``:
its forward ``_fwd_kernel`` (``_core``) and its backward ``_bwd_kernel``.
Under the ``recent`` strategy a query's K neighbors are one contiguous run
of CSR entries, so their [node || edge] rows are K consecutive rows of
``csr.feat_entry`` (packed row-major, Dn + De columns): one contiguous
block. The forward (``csrc/attention_core.cuh``, as in
``ops/gathered_attention.py``) stages exactly those rows once per query with
16-byte loads, times the mask in shared memory (a masked row is not read:
it becomes the zero row the gather path reads), and computes Phi(dt) beside
them, each cosine once, with the rounding of ``csrc/phi.cuh`` and the
cosine of ``csrc/cos_reduced.cuh`` (cosf's bits without its slow path); it
never projects a kv row, and the gathered features,
the time features and key and val exist nowhere. None of the JAX kernel's
Mosaic aids is needed: no 8-row-aligned superset windows
(``_expand_to_aligned``), no keep rescale, no zero weight rows for a
128-lane table (``_pad_weight_rows``, and so no ``_strip_weight_rows`` on
the gradients).

Callers keep every window inside the table: starts in [0, T - K]
(``TGAT.sample`` clamps the guard-offset starts as the JAX package does).

``window_attention`` is a ``torch.autograd.Function``: on CUDA tensors its
forward and backward launch the two kernels, on CPU tensors they run the
plain forward and the explicit plain backward below. Gradients flow to q3,
tw, tb, wk and wv; the table, starts, dt, mask and keep get none, as in the
JAX ``_wa_bwd``. The backward is ``ops/gathered_attention.py``'s
(``csrc/attention_bwd.cuh``) with this kernel's loader.

Bounds on one H100 at the TGAT batch, layer 1, hop 1 (M = 12,000, K = 20,
a 344-wide table, Dt = 100, Dq = 272), the per-head products on the tensor
cores in split TF32: as the gathered kernel's, forward 6.7 G operations ->
0.048 ms, backward 16.4 G -> 0.116 ms; the valid window rows read (at most
330 MB) -> 0.099 ms.

What the design leaves on the table: as ``ops/gathered_attention.py``
(per-head products at about a quarter of their split-TF32 bound; qk and Av
through device memory between launches).
"""
from __future__ import annotations

import torch

from . import _attention, _build

_NAME = "window_attention"
_ARGTYPES = (
    [_build.P] * 9 + [_build.I] * 2 + [_build.P] + [_build.I] * 2 + [_build.P] * 2
    + [_build.I] * 6 + [_build.F] + [_build.I] * 2 + [_build.P]
)
_BWD_ARGTYPES = (
    [_build.P] * 9 + [_build.I] * 2 + [_build.P] + [_build.I] * 2 + [_build.P] * 8
    + [_build.I] * 6 + [_build.F] + [_build.I] * 4 + [_build.P]
)


def _kv(starts, dt, mask, table, tw, tb):
    m, k = dt.shape
    rows = starts.long()[:, None] + torch.arange(k, device=starts.device)
    feat = table[rows] * mask[..., None]
    phi = torch.cos(dt[..., None] * tw + tb)
    return torch.cat([feat, phi], dim=-1).reshape(m * k, -1)


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
    key, val = _attention.project_kv(_kv(starts, dt, mask, table, tw, tb), wk, wv, compute_dtype)
    out, _ = _attention.attend(q3, key.view(m, k, -1), val.view(m, k, -1), mask, keep, num_heads)
    return out


def window_attention_backward_plain(
    q3, starts, dt, mask, keep, table, tw, tb, wkv, dout, num_heads: int,
    compute_dtype: torch.dtype = torch.float32, abs_terms: bool = False,
):
    """The explicit backward, with the JAX ``_wa_bwd``'s residuals and
    cotangent: dout (M, Dq) -> (dq3, dtw, dtb, dwk, dwv) (the table,
    starts, dt, mask and keep get none).

    ``compute_dtype=torch.bfloat16`` rounds the JAX kernel's operands to
    bf16 for its products; ``abs_terms`` gives each output's sums of
    |terms| (``ops/_attention.py``).
    """
    wk, wv = wkv
    d_feat = table.shape[-1]
    dq3, dphi, dwk, dwv = _attention.attention_backward(
        q3, _kv(starts, dt, mask, table, tw, tb), mask, keep, wk, wv, dout, None, num_heads,
        kv_cols=slice(d_feat, None), compute_dtype=compute_dtype, abs_terms=abs_terms,
    )
    dtw, dtb = _attention.time_param_grads(dphi, dt.reshape(-1), tw, tb, abs_terms)
    return dq3, dtw, dtb, dwk, dwv


def _check(q3, starts, dt, mask, keep, table, tw, tb, wk, wv, num_heads):
    t_rows, width = table.shape
    dt_dim = tw.shape[-1]
    m, k, dq, wk_s, wv_s = _attention.check_attention(
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
    return m, k, dq, width, dt_dim, wk_s, wv_s


def _forward_kernel(q3, starts, dt, mask, keep, table, tw, tb, wk, wv, num_heads):
    m, k, dq, width, dt_dim, (wk_sk, wk_sn), (wv_sk, wv_sn) = _check(
        q3, starts, dt, mask, keep, table, tw, tb, wk, wv, num_heads
    )
    dev = q3.device
    scratch = _attention.forward_scratch(m, width + dt_dim, num_heads, dev)
    out = torch.empty((m, dq), dtype=torch.float32, device=dev)
    lib = _build.load(_NAME, "window_attention_forward", _ARGTYPES)
    rc = lib.window_attention_forward(
        q3.data_ptr(), table.data_ptr(), starts.data_ptr(), dt.data_ptr(), tw.data_ptr(),
        tb.data_ptr(), mask.data_ptr(), keep.data_ptr(), wk.data_ptr(), wk_sk, wk_sn,
        wv.data_ptr(), wv_sk, wv_sn, scratch.data_ptr(), out.data_ptr(), m, k, width, dt_dim,
        dq, num_heads, _attention.head_scale(dq, num_heads),
        *_attention.forward_plan(m, width + dt_dim, dq, num_heads, dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    _build.count_launch(window_attention)
    return out


def window_attention_backward(q3, starts, dt, mask, keep, table, tw, tb, wkv, dout,
                              num_heads: int):
    """As ``window_attention_backward_plain`` (f32). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if q3.device.type == "cpu":
        return window_attention_backward_plain(
            q3, starts, dt, mask, keep, table, tw, tb, wkv, dout, num_heads
        )
    if q3.device.type != "cuda":
        raise ValueError(f"window_attention_backward: unsupported device {q3.device}")
    wk, wv = wkv
    m, k, dq, width, dt_dim, (wk_sk, wk_sn), (wv_sk, wv_sn) = _check(
        q3, starts, dt, mask, keep, table, tw, tb, wk, wv, num_heads
    )
    f32, dev = torch.float32, q3.device
    _build.require(dout, "dout", f32, (m, dq), dev)
    if m == 0:
        return (torch.empty((0, dq), dtype=f32, device=dev), torch.zeros_like(tw),
                torch.zeros_like(tb), torch.zeros_like(wk), torch.zeros_like(wv))
    kv_dim = width + dt_dim
    scratch, partial, plan = _attention.backward_scratch(m, k, kv_dim, dq, num_heads, dev,
                                                             dt_dim)
    new = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    part = new(m, 2, dt_dim)  # per query: dtw's and dtb's sums
    dq3, dwk, dwv, dt_grads = new(m, dq), new(kv_dim, dq), new(kv_dim, dq), new(2, dt_dim)
    lib = _build.load(_NAME, "window_attention_backward", _BWD_ARGTYPES)
    rc = lib.window_attention_backward(
        q3.data_ptr(), table.data_ptr(), starts.data_ptr(), dt.data_ptr(), tw.data_ptr(),
        tb.data_ptr(), mask.data_ptr(), keep.data_ptr(), wk.data_ptr(), wk_sk, wk_sn,
        wv.data_ptr(), wv_sk, wv_sn, dout.data_ptr(), scratch.data_ptr(), partial.data_ptr(),
        part.data_ptr(), dq3.data_ptr(), dwk.data_ptr(), dwv.data_ptr(), dt_grads.data_ptr(),
        m, k, width, dt_dim, dq, num_heads,
        _attention.head_scale(dq, num_heads), *plan, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, f"{_NAME} backward")
    _build.count_launch(window_attention_backward)
    return dq3, dt_grads[0], dt_grads[1], dwk, dwv


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q3, starts, dt, mask, keep, table, tw, tb, wk, wv, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q3, starts, dt, mask, keep, table, tw, tb, wk, wv)
        if q3.device.type == "cpu":
            return window_attention_plain(q3, starts, dt, mask, keep, table, tw, tb, (wk, wv),
                                          num_heads)
        return _forward_kernel(q3, starts, dt, mask, keep, table, tw, tb, wk, wv, num_heads)

    @staticmethod
    def backward(ctx, dout):
        q3, starts, dt, mask, keep, table, tw, tb, wk, wv = ctx.saved_tensors
        dq3, dtw, dtb, dwk, dwv = window_attention_backward(
            q3, starts, dt, mask, keep, table, tw, tb, (wk, wv), dout.contiguous(), ctx.num_heads
        )
        return dq3, None, None, None, None, None, dtw, dtb, dwk, dwv, None


def window_attention(q3, starts, dt, mask, keep, table, tw, tb, wkv, num_heads: int):
    """As ``window_attention_plain`` (f32), differentiable in q3, tw, tb, wk
    and wv. The weights may be row-major or the transpose of nn.Linear's
    (Dq, Dkv) weight. CPU tensors take the plain versions; CUDA tensors
    launch the kernels."""
    if q3.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attention: unsupported device {q3.device}")
    wk, wv = wkv
    return _WindowAttention.apply(q3, starts, dt, mask, keep, table, tw, tb, wk, wv, num_heads)


window_attention.launches = window_attention.captured = 0
window_attention_backward.launches = window_attention_backward.captured = 0
