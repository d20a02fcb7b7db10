"""Fused time-channel patch projection for DyGFormer (CUDA, ``csrc/time_channel.cu``).

    out = patches(where(valid, cos(dt[..., None] * tw + tb), 0)) @ w + bias

Replaces ``dyglib_tpu/ops/pallas/time_channel.py::_fwd_kernel`` (the
forward of ``time_channel_projection``; the backward comes with training).
The masked Phi tensor (M, L, Dt) is computed tile by tile in shared memory
and contracted at once; it never reaches device memory.

Bound on one H100 at the slice's shapes (B=200 eval triple, M=600 rows,
Dt=100, ced=50), counting each input read once and the output written once,
operations (matmul multiply-adds as two, plus the argument's multiply and
add and the mask's multiply; the cosines uncounted) against the 67 TFLOP/s
float32 CUDA-core peak and bytes against 3.35 TB/s:
  * CanParl (L=2048, patch 64): 12.7 G operations -> 0.19 ms; 11.3 MB
    (valid is bool) -> 3.4 us. Bound by operations.
  * wikipedia (L=32, patch 1): 0.20 G operations -> 3.0 us; 4.0 MB ->
    1.2 us. Bound by operations, and in practice by launch latency.

What the simple design leaves on the table: it runs f32 FMAs on CUDA
cores (TF32 or bf16 tensor cores would lift the bound ~7-15x); the
accurate ``cosf`` takes its slow path above |theta| ~ 1e5, which the
synthetic and real streams reach; the 64-wide column tile wastes 14 of
64 lanes at ced=50; slices of Phi and W are not double-buffered.
"""
from __future__ import annotations

import torch

from . import _build

_NAME = "time_channel"
_ARGTYPES = [_build.P] * 5 + [_build.I] * 2 + [_build.P] * 2 + [_build.I] * 4 + [_build.P]


def time_channel_projection_plain(
    dt: torch.Tensor,
    valid: torch.Tensor,
    tw: torch.Tensor,
    tb: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    patch: int,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version, with the JAX signature (``valid`` may also be
    bool).

    ``compute_dtype=torch.bfloat16`` rounds the matmul operands to bf16 and
    accumulates in f32, the math of the JAX oracle
    ``time_channel_projection_reference``.
    """
    m, l = dt.shape
    p = l // patch
    phi = torch.where(valid[..., None] != 0, torch.cos(dt[..., None] * tw + tb), 0.0)
    x = phi.reshape(m * p, patch * tw.shape[-1])
    if compute_dtype != torch.float32:
        x, w = x.to(compute_dtype).float(), w.to(compute_dtype).float()
    return (x @ w + bias).reshape(m, p, -1)


def time_channel_projection(
    dt: torch.Tensor,
    valid: torch.Tensor,
    tw: torch.Tensor,
    tb: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    patch: int,
) -> torch.Tensor:
    """dt (M, L) f32, valid (M, L) bool; tw, tb (Dt,); w (patch*Dt, ced);
    bias (ced,) -> (M, L // patch, ced) f32.

    ``w`` may be row-major or the transpose of nn.Linear's (ced, patch*Dt)
    weight; the kernel reads either in place. CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if dt.device.type == "cpu":
        return time_channel_projection_plain(dt, valid, tw, tb, w, bias, patch)
    if dt.device.type != "cuda":
        raise ValueError(f"time_channel_projection: unsupported device {dt.device}")
    m, l = dt.shape
    dt_dim = tw.shape[0]
    ced = w.shape[-1]
    if patch < 1 or l % patch:
        raise ValueError(f"sequence length {l} is not a multiple of patch {patch}")
    f32, dev = torch.float32, dt.device
    for t, name, dtype, shape in (
        (dt, "dt", f32, (m, l)), (valid, "valid", torch.bool, (m, l)),
        (tw, "tw", f32, (dt_dim,)), (tb, "tb", f32, (dt_dim,)), (bias, "bias", f32, (ced,)),
    ):
        _build.require(t, name, dtype, shape, dev)
    w_sk, w_sn = _build.require_weight(w, "w", f32, (patch * dt_dim, ced), dev)
    rows = m * (l // patch)
    out = torch.empty((rows, ced), dtype=f32, device=dev)
    lib = _build.load(_NAME, "time_channel_forward", _ARGTYPES)
    rc = lib.time_channel_forward(
        dt.data_ptr(), valid.data_ptr(), tw.data_ptr(), tb.data_ptr(), w.data_ptr(), w_sk,
        w_sn, bias.data_ptr(), out.data_ptr(), rows, patch, dt_dim, ced,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    time_channel_projection.launches += 1
    return out.view(m, l // patch, ced)


time_channel_projection.launches = 0
