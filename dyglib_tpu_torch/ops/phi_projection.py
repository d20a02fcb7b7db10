"""Fused Phi(dt) @ W projection for TGAT (CUDA, ``csrc/phi_projection.cu``).

    out = cos(dt[:, None] * tw + tb) @ w     (R, Dt) @ (Dt, Dq) -> (R, Dq)

Replaces ``dyglib_tpu/ops/pallas/phi_projection.py::phi_projection``: its
forward ``_fwd_kernel`` and its backward ``_bwd_kernel``. A kv row is
[feat || Phi(dt)], so key = feat @ Wk[:Df] + Phi(dt) @ Wk[Df:]: TGAT's
``use_phi_fusion`` computes the second term here, for key and for val, and
the (R, Dt) time features never reach device memory. It is the time
channel of ``csrc/time_channel.cu`` at patch 1 with no mask and no bias,
and shares its A loader (``csrc/phi.cuh``): the same rounding of the
argument and the accurate cosine. No mask: pad rows are handled by the
attention's logits, not here.

``phi_projection`` is a ``torch.autograd.Function``: on CUDA tensors its
forward and backward launch the two kernels, on CPU tensors they run the
plain forward and the explicit plain backward below. The backward is the
time channel's (``csrc/phi.cuh`` ``launch_phi_backward``): dw = Phi^T @ dout
with Phi recomputed by the loader, and dtw, dtb through dPhi = dout @ w^T
and -sin(theta), both deterministic two-pass sums. dt gets no gradient.

Bounds on one H100 at the TGAT batch (layer 1, hop 1: R = 240,000, Dt =
100, Dq = 272), f32 on CUDA cores: forward 13.1 G operations -> 0.196 ms
at 67 T/s, 262 MB written -> 0.078 ms; backward two products, 26.1 G
operations -> 0.39 ms, 262 MB of dout read -> 0.078 ms. Bound by
operations.

What the simple design leaves on the table: the (R, Dq) product is written
to device memory and read back by the add of the feature term (fusing both
terms into one kernel is what ``ops/gathered_attention.py`` does); f32 on
CUDA cores; the backward computes Phi in the dw pass and sin(theta) again
in the dPhi pass.
"""
from __future__ import annotations

import torch

from . import _attention, _build

_NAME = "phi_projection"
_ARGTYPES = [_build.P] * 4 + [_build.I] * 2 + [_build.P] + [_build.I] * 3 + [_build.P]
_BWD_ARGTYPES = (
    [_build.P] * 4 + [_build.I] * 2 + [_build.P] * 7 + [_build.I] * 4 + [_build.P]
)


def phi_projection_plain(dt, tw, tb, w, compute_dtype: torch.dtype = torch.float32):
    """Plain PyTorch version, with the JAX signature: dt (R,) or (R, 1);
    tw, tb (Dt,); w (Dt, Dq) -> (R, Dq) f32.

    ``compute_dtype=torch.bfloat16`` rounds Phi and w to bf16 and
    accumulates in f32, the math of the JAX oracle
    ``phi_projection_reference``.
    """
    phi = torch.cos(dt.reshape(-1, 1) * tw + tb)
    phi, w = _attention.rounded(compute_dtype, phi, w)
    return phi @ w


def phi_projection_backward_plain(dt, tw, tb, w, dout,
                                  compute_dtype: torch.dtype = torch.float32,
                                  abs_terms: bool = False):
    """The explicit backward, with the JAX ``_bwd``'s residuals and
    cotangent: dout (R, Dq) -> (dtw, dtb, dw) (dt gets none):

        dw = Phi^T @ dout,  dPhi = dout @ w^T,
        dtb = sum -dPhi * sin(theta),  dtw = sum -dPhi * sin(theta) * dt

    ``compute_dtype=torch.bfloat16`` rounds Phi, dout and w to bf16 for the
    two products, the math of the JAX kernel's ``_bwd_kernel``;
    ``abs_terms`` gives each output's sums of |terms| (``ops/_attention.py``).
    """
    dt = dt.reshape(-1)
    phi = torch.cos(dt[:, None] * tw + tb)
    phi, g, w = _attention.rounded(compute_dtype, phi, dout, w)
    if abs_terms:
        phi, g, w = phi.abs(), g.abs(), w.abs()
    dtw, dtb = _attention.time_param_grads(g @ w.t(), dt, tw, tb, abs_terms)
    return dtw, dtb, phi.t() @ g


def _check(dt, tw, tb, w):
    rows, dt_dim, dq = dt.shape[0], tw.shape[-1], w.shape[-1]
    f32, dev = torch.float32, dt.device
    for t, name, shape in ((dt, "dt", (rows,)), (tw, "tw", (dt_dim,)), (tb, "tb", (dt_dim,))):
        _build.require(t, name, f32, shape, dev)
    _require_strided(w, (dt_dim, dq), dev)
    if rows * dq >= 2**31:
        raise ValueError(f"{rows} x {dq} outputs; the kernel indexes with int32")
    return rows, dt_dim, dq


def _forward_kernel(dt, tw, tb, w):
    rows, dt_dim, dq = _check(dt, tw, tb, w)
    dev = dt.device
    out = torch.empty((rows, dq), dtype=torch.float32, device=dev)
    lib = _build.load(_NAME, "phi_projection_forward", _ARGTYPES)
    rc = lib.phi_projection_forward(
        dt.data_ptr(), tw.data_ptr(), tb.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
        out.data_ptr(), rows, dt_dim, dq, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    phi_projection.launches += 1
    return out


def phi_projection_backward(dt, tw, tb, w, dout):
    """As ``phi_projection_backward_plain`` (f32): dt (R,) -> (dtw, dtb, dw).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if dt.device.type == "cpu":
        return phi_projection_backward_plain(dt, tw, tb, w, dout)
    if dt.device.type != "cuda":
        raise ValueError(f"phi_projection_backward: unsupported device {dt.device}")
    rows, dt_dim, dq = _check(dt, tw, tb, w)
    f32, dev = torch.float32, dt.device
    _build.require(dout, "dout", f32, (rows, dq), dev)
    chunk = _build.weight_grad_chunk_rows(rows, dt_dim, dq)
    row_tiles = max(1, -(-rows // _build.TILE_ROWS))
    new = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    dw_ext, dtw, dtb = new(dt_dim + 1, dq), new(dt_dim), new(dt_dim)
    partial = new(max(1, -(-rows // chunk)), dt_dim + 1, dq)
    part_tw, part_tb = new(row_tiles, dt_dim), new(row_tiles, dt_dim)
    lib = _build.load(_NAME, "phi_projection_backward", _BWD_ARGTYPES)
    rc = lib.phi_projection_backward(
        dt.data_ptr(), tw.data_ptr(), tb.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
        dout.data_ptr(), dw_ext.data_ptr(), dtw.data_ptr(), dtb.data_ptr(), partial.data_ptr(),
        part_tw.data_ptr(), part_tb.data_ptr(), rows, dt_dim, dq, chunk,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, f"{_NAME} backward")
    phi_projection_backward.launches += 1
    return dtw, dtb, dw_ext[:dt_dim]


class _PhiProjection(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dt, tw, tb, w):
        ctx.save_for_backward(dt, tw, tb, w)
        if dt.device.type == "cpu":
            return phi_projection_plain(dt, tw, tb, w)
        return _forward_kernel(dt, tw, tb, w)

    @staticmethod
    def backward(ctx, dout):
        dt, tw, tb, w = ctx.saved_tensors
        dtw, dtb, dw = phi_projection_backward(dt, tw, tb, w, dout.contiguous())
        return None, dtw, dtb, dw


def phi_projection(dt, tw, tb, w):
    """As ``phi_projection_plain`` (f32), differentiable in tw, tb and w.
    ``w`` may be any (Dt, Dq) view with one unit stride, such as rows of
    nn.Linear's weight transposed (``weight.t()[Df:]``). CPU tensors take
    the plain versions; CUDA tensors launch the kernels."""
    if dt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"phi_projection: unsupported device {dt.device}")
    return _PhiProjection.apply(dt.reshape(-1), tw, tb, w)


def _require_strided(w, shape, device) -> None:
    """Raise unless ``w`` is an f32 ``shape`` view on ``device`` with one
    unit stride (the kernel reads w[k, c] at k * stride(0) + c * stride(1))."""
    if w.device != device or w.dtype != torch.float32 or tuple(w.shape) != tuple(shape):
        raise ValueError(
            f"w must be float32 {tuple(shape)} on {device}; got {w.dtype} "
            f"{tuple(w.shape)} on {w.device}"
        )
    if 1 not in w.stride():
        raise ValueError(f"w has strides {w.stride()}; the kernel needs one unit stride")


phi_projection.launches = 0
phi_projection_backward.launches = 0
