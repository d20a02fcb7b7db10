"""Patch-flattened channel projection for DyGFormer (CUDA, ``csrc/patch_projection.cu``).

    out = patches(x) @ w + bias,   patches: (M, Lp, D) -> (M, P, patch * D)

Replaces ``dyglib_tpu/ops/pallas/patch_projection.py::_fwd_kernel`` (the
forward; the dW/dbias backward comes with training). It projects the
frozen node and edge channels, reading x (M, Lp, D) row-major against W
viewed (patch, D, ced); the flattened (M, P, patch * D) tensor is never
written (in a row-major layout it is the same bytes).

Bound on one H100 at the slice's shapes (B=200 eval triple, M=600 rows,
D=172, ced=50), each input read once and the output written once, FLOPs
against the 67 TFLOP/s float32 CUDA-core peak, bytes against 3.35 TB/s:
  * CanParl (Lp=2048, patch 64): 21.1 GFLOP -> 0.32 ms; 851 MB -> 0.25 ms.
    Bound by operations, with bytes close behind.
  * wikipedia (Lp=32, patch 1): 0.33 GFLOP -> 4.9 us; 17 MB -> 5.1 us.

What the simple design leaves on the table: f32 FMAs on CUDA cores where
TF32 or bf16 tensor cores (wgmma) would make it purely bytes-bound; x
could be gathered straight from the feature tables inside the kernel
instead of from a gathered (M, Lp, D) copy, which would cut its bytes by
the table reuse; the 64-wide column tile wastes 14 of 64 lanes at ced=50.
"""
from __future__ import annotations

import torch

from . import _build

_NAME = "patch_projection"
_ARGTYPES = [_build.P] * 2 + [_build.I] * 2 + [_build.P] * 2 + [_build.I] * 3 + [_build.P]


def patch_projection_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    patch: int,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version, with the JAX signature.

    ``compute_dtype=torch.bfloat16`` rounds the matmul operands to bf16 and
    accumulates in f32, the math of the JAX oracle
    ``patch_projection_reference``.
    """
    m, lp, d = x.shape
    p = lp // patch
    xf = x.reshape(m * p, patch * d)
    if compute_dtype != torch.float32:
        xf, w = xf.to(compute_dtype).float(), w.to(compute_dtype).float()
    return (xf @ w + bias).reshape(m, p, -1)


def patch_projection(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, patch: int
) -> torch.Tensor:
    """x (M, Lp, D) f32; w (patch*D, ced); bias (ced,) -> (M, Lp // patch, ced).

    ``w`` may be row-major or the transpose of nn.Linear's (ced, patch*D)
    weight; the kernel reads either in place. CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if x.device.type == "cpu":
        return patch_projection_plain(x, w, bias, patch)
    if x.device.type != "cuda":
        raise ValueError(f"patch_projection: unsupported device {x.device}")
    m, lp, d = x.shape
    ced = w.shape[-1]
    if patch < 1 or lp % patch:
        raise ValueError(f"sequence length {lp} is not a multiple of patch {patch}")
    f32, dev = torch.float32, x.device
    _build.require(x, "x", f32, (m, lp, d), dev)
    _build.require(bias, "bias", f32, (ced,), dev)
    w_sk, w_sn = _build.require_weight(w, "w", f32, (patch * d, ced), dev)
    rows = m * (lp // patch)
    out = torch.empty((rows, ced), dtype=f32, device=dev)
    lib = _build.load(_NAME, "patch_projection_forward", _ARGTYPES)
    rc = lib.patch_projection_forward(
        x.data_ptr(), w.data_ptr(), w_sk, w_sn, bias.data_ptr(), out.data_ptr(), rows,
        patch * d, ced, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    patch_projection.launches += 1
    return out.view(m, lp // patch, ced)


patch_projection.launches = 0
