"""Post-gather fused temporal attention for TGAT (CUDA, ``csrc/gathered_attention.cu``).

    kv = [feat_n || feat_e || cos(dt * tw + tb)]  (M * K rows)
    then key, val, masked softmax, keep, weighted sum (``ops/_attention.py``)

Replaces ``dyglib_tpu/ops/pallas/gathered_attention.py::gathered_attention``:
its forward ``_fwd_kernel`` and its backward ``_bwd_kernel``. TGAT runs it
at layer 1, whose kv rows are raw feature rows gathered from the tables
(pad rows are the zero id-0 rows, so nothing is masked here). The node and
edge rows arrive as two slabs, in which a query's K rows are contiguous.
The forward (``csrc/attention_core.cuh``) never projects a kv row: qk =
Wk_h q3_h per query and head on the split-TF32 tensor-core tile
(``csrc/head_gemm.cuh``, f32-accurate); one block per query
stages its K rows once (16-byte loads) and computes Phi(dt) beside them in
shared memory, each cosine once, then the logits kv . qk, the softmax and
Av = sum_j w kv_j; out_h = Av Wv_h on the tile. Neither the (M * K, Dt)
time features, the (M * K, 444) concatenation nor key and val exist
anywhere. Phi's argument is rounded as PyTorch's separate multiply and add
round it, and the cosine is ``csrc/cos_reduced.cuh``'s, cosf's bits without
its Payne-Hanek slow path: dt reaches ~2.6e6 on the wikipedia-scale
stream, where theta passes 105615.

``gathered_attention`` is a ``torch.autograd.Function``: on CUDA tensors
its forward and backward launch the two kernels, on CPU tensors they run
the plain forward and the explicit plain backward below. Gradients flow to
q3, the time encoder's tw and tb, wk and wv; the feature slabs, dt, mask
and keep get none, as in the JAX ``_ga_bwd``. The backward
(``csrc/attention_bwd.cuh``) stages each query's K rows through the
forward's loader once, with -sin(theta) from the cosine's own reduction
beside Phi, and never projects a kv row; one block of 256 threads a
query, the softmax's backward one warp a head; dtw and dtb come from the
Phi columns of dkv times the staged sines, summed per query, then over
queries in a fixed order (deterministic).

Bounds on one H100 at the TGAT batch (B = 200 triple, K = 20, Dn = De =
172, Dt = 100, Dq = 272), the per-head products at the 165 T/s of three
TF32 passes, the rest at the 67 T/s of the f32 CUDA cores, bytes against
3.35 TB/s, at hop 1 (M = 12,000, 240,000 kv rows):
  * forward: the function needs 6.7 G operations (logits against qk =
    Wk_h q3_h, out_h = (sum_j w kv_j) Wv_h; 5.8 G of them the products)
    -> 0.048 ms; 330 MB of feature rows read -> 0.099 ms: bound by the
    bytes. The (2, M, H, Dkv) scratch of qk and Av adds ~170 MB of
    traffic.
  * backward: 16.4 G operations (14.5 G the products) -> 0.116 ms; 330 MB
    read -> 0.099 ms. Bound by operations.
At hop 0 (M = 600) each is 1/20 of that.

What the design leaves on the table: the per-head products run at about a
quarter of their split-TF32 bound, held by their staging, not by the
tensor cores (PERF.md); qk and Av pass through device memory between the
launches.
"""
from __future__ import annotations

import torch

from . import _attention, _build

_NAME = "gathered_attention"
_ARGTYPES = (
    [_build.P] * 9 + [_build.I] * 2 + [_build.P] + [_build.I] * 2 + [_build.P] * 2
    + [_build.I] * 7 + [_build.F] + [_build.I] * 2 + [_build.P]
)
_BWD_ARGTYPES = (
    [_build.P] * 9 + [_build.I] * 2 + [_build.P] + [_build.I] * 2 + [_build.P] * 8
    + [_build.I] * 7 + [_build.F] + [_build.I] * 4 + [_build.P]
)


def _kv(feat_n, feat_e, dt, tw, tb):
    m, k = dt.shape
    phi = torch.cos(dt.reshape(m * k, 1) * tw + tb)
    return torch.cat([feat_n, feat_e, phi], dim=-1)


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
    key, val = _attention.project_kv(_kv(feat_n, feat_e, dt, tw, tb), wk, wv, compute_dtype)
    out, _ = _attention.attend(q3, key.view(m, k, -1), val.view(m, k, -1), mask, keep, num_heads)
    return out


def gathered_attention_backward_plain(
    q3, feat_n, feat_e, dt, mask, keep, time_wb, wkv, dout, num_heads: int,
    compute_dtype: torch.dtype = torch.float32, abs_terms: bool = False,
):
    """The explicit backward, with the JAX ``_ga_bwd``'s residuals and
    cotangent: dout (M, Dq) -> (dq3, dtw, dtb, dwk, dwv) (the feature slabs,
    dt, mask and keep get none).

    ``compute_dtype=torch.bfloat16`` rounds the JAX kernel's operands to
    bf16 for its products; ``abs_terms`` gives each output's sums of
    |terms| (``ops/_attention.py``).
    """
    (tw, tb), (wk, wv) = time_wb, wkv
    dt_dim = tw.shape[-1]
    d_feat = wk.shape[0] - dt_dim
    dq3, dphi, dwk, dwv = _attention.attention_backward(
        q3, _kv(feat_n, feat_e, dt, tw, tb), mask, keep, wk, wv, dout, None, num_heads,
        kv_cols=slice(d_feat, None), compute_dtype=compute_dtype, abs_terms=abs_terms,
    )
    dtw, dtb = _attention.time_param_grads(dphi, dt.reshape(-1), tw, tb, abs_terms)
    return dq3, dtw, dtb, dwk, dwv


def _check(q3, feat_n, feat_e, dt, mask, keep, tw, tb, wk, wv, num_heads):
    dn, de, dt_dim = feat_n.shape[-1], feat_e.shape[-1], tw.shape[-1]
    m, k, dq, wk_s, wv_s = _attention.check_attention(
        q3, mask, keep, wk, wv, dn + de + dt_dim, num_heads
    )
    for t, name, shape in (
        (feat_n, "feat_n", (m * k, dn)), (feat_e, "feat_e", (m * k, de)), (dt, "dt", (m, k)),
        (tw, "tw", (dt_dim,)), (tb, "tb", (dt_dim,)),
    ):
        _build.require(t, name, torch.float32, shape, q3.device)
    return m, k, dq, dn, de, dt_dim, wk_s, wv_s


def _forward_kernel(q3, feat_n, feat_e, dt, mask, keep, tw, tb, wk, wv, num_heads):
    m, k, dq, dn, de, dt_dim, (wk_sk, wk_sn), (wv_sk, wv_sn) = _check(
        q3, feat_n, feat_e, dt, mask, keep, tw, tb, wk, wv, num_heads
    )
    dev = q3.device
    scratch = _attention.forward_scratch(m, dn + de + dt_dim, num_heads, dev)
    out = torch.empty((m, dq), dtype=torch.float32, device=dev)
    lib = _build.load(_NAME, "gathered_attention_forward", _ARGTYPES)
    rc = lib.gathered_attention_forward(
        q3.data_ptr(), feat_n.data_ptr(), feat_e.data_ptr(), dt.data_ptr(), tw.data_ptr(),
        tb.data_ptr(), mask.data_ptr(), keep.data_ptr(), wk.data_ptr(), wk_sk, wk_sn,
        wv.data_ptr(), wv_sk, wv_sn, scratch.data_ptr(), out.data_ptr(), m, k, dn, de, dt_dim,
        dq, num_heads, _attention.head_scale(dq, num_heads),
        *_attention.forward_plan(m, dn + de + dt_dim, dq, num_heads, dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    _build.count_launch(gathered_attention)
    return out


def gathered_attention_backward(q3, feat_n, feat_e, dt, mask, keep, time_wb, wkv, dout,
                                num_heads: int):
    """As ``gathered_attention_backward_plain`` (f32). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if q3.device.type == "cpu":
        return gathered_attention_backward_plain(
            q3, feat_n, feat_e, dt, mask, keep, time_wb, wkv, dout, num_heads
        )
    if q3.device.type != "cuda":
        raise ValueError(f"gathered_attention_backward: unsupported device {q3.device}")
    (tw, tb), (wk, wv) = time_wb, wkv
    m, k, dq, dn, de, dt_dim, (wk_sk, wk_sn), (wv_sk, wv_sn) = _check(
        q3, feat_n, feat_e, dt, mask, keep, tw, tb, wk, wv, num_heads
    )
    f32, dev = torch.float32, q3.device
    _build.require(dout, "dout", f32, (m, dq), dev)
    if m == 0:
        return (torch.empty((0, dq), dtype=f32, device=dev), torch.zeros_like(tw),
                torch.zeros_like(tb), torch.zeros_like(wk), torch.zeros_like(wv))
    kv_dim = dn + de + dt_dim
    scratch, partial, plan = _attention.backward_scratch(m, k, kv_dim, dq, num_heads, dev,
                                                             dt_dim)
    new = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    part = new(m, 2, dt_dim)  # per query: dtw's and dtb's sums
    dq3, dwk, dwv, dt_grads = new(m, dq), new(kv_dim, dq), new(kv_dim, dq), new(2, dt_dim)
    lib = _build.load(_NAME, "gathered_attention_backward", _BWD_ARGTYPES)
    rc = lib.gathered_attention_backward(
        q3.data_ptr(), feat_n.data_ptr(), feat_e.data_ptr(), dt.data_ptr(), tw.data_ptr(),
        tb.data_ptr(), mask.data_ptr(), keep.data_ptr(), wk.data_ptr(), wk_sk, wk_sn,
        wv.data_ptr(), wv_sk, wv_sn, dout.data_ptr(), scratch.data_ptr(), partial.data_ptr(),
        part.data_ptr(), dq3.data_ptr(), dwk.data_ptr(), dwv.data_ptr(), dt_grads.data_ptr(),
        m, k, dn, de, dt_dim, dq, num_heads,
        _attention.head_scale(dq, num_heads), *plan, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, f"{_NAME} backward")
    _build.count_launch(gathered_attention_backward)
    return dq3, dt_grads[0], dt_grads[1], dwk, dwv


class _GatheredAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q3, feat_n, feat_e, dt, mask, keep, tw, tb, wk, wv, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q3, feat_n, feat_e, dt, mask, keep, tw, tb, wk, wv)
        if q3.device.type == "cpu":
            return gathered_attention_plain(q3, feat_n, feat_e, dt, mask, keep, (tw, tb),
                                            (wk, wv), num_heads)
        return _forward_kernel(q3, feat_n, feat_e, dt, mask, keep, tw, tb, wk, wv, num_heads)

    @staticmethod
    def backward(ctx, dout):
        q3, feat_n, feat_e, dt, mask, keep, tw, tb, wk, wv = ctx.saved_tensors
        dq3, dtw, dtb, dwk, dwv = gathered_attention_backward(
            q3, feat_n, feat_e, dt, mask, keep, (tw, tb), (wk, wv), dout.contiguous(),
            ctx.num_heads,
        )
        return dq3, None, None, None, None, None, dtw, dtb, dwk, dwv, None


def gathered_attention(q3, feat_n, feat_e, dt, mask, keep, time_wb, wkv, num_heads: int):
    """As ``gathered_attention_plain`` (f32), differentiable in q3, tw, tb,
    wk and wv. The weights may be row-major or the transpose of nn.Linear's
    (Dq, Dkv) weight. CPU tensors take the plain versions; CUDA tensors
    launch the kernels."""
    if q3.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gathered_attention: unsupported device {q3.device}")
    (tw, tb), (wk, wv) = time_wb, wkv
    return _GatheredAttention.apply(q3, feat_n, feat_e, dt, mask, keep, tw, tb, wk, wv, num_heads)


gathered_attention.launches = gathered_attention.captured = 0
gathered_attention_backward.launches = gathered_attention_backward.captured = 0
