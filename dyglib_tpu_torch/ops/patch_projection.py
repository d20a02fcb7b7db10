"""Patch-flattened channel projection for DyGFormer (CUDA, ``csrc/patch_projection.cu``).

    out = patches(x) @ w + bias,   patches: (M, Lp, D) -> (M, P, patch * D)

Replaces ``dyglib_tpu/ops/pallas/patch_projection.py``: ``_fwd_kernel``
(forward) and ``_bwd_kernel`` (dW = patches(x)^T @ dout, dbias = sum of
dout; no dx). It projects the frozen node and edge channels, reading
x (M, Lp, D) row-major against W viewed (patch, D, ced); the flattened
(M, P, patch * D) tensor is never written (in a row-major layout it is the
same bytes). ``patch_projection`` is a ``torch.autograd.Function``: on CUDA
tensors its forward and backward launch the two kernels; on CPU tensors
they run the plain versions below. x gets no gradient, as in the JAX
package: it holds rows of the feature tables, which are never trained.

Bounds on one H100 (M = 600 rows of the B = 200 triple, D = 172,
ced = 50), each input read once and each output written once, operations
against the 67 T/s float32 CUDA-core peak, bytes against 3.35 TB/s:
  * forward, CanParl (Lp = 2048, patch 64): 21.1 G operations -> 0.32 ms;
    851 MB -> 0.25 ms. wikipedia (Lp = 32, patch 1): 0.33 G -> 4.9 us;
    17 MB -> 5.1 us.
  * backward, CanParl: 21.1 G operations (plus the dbias row) -> 0.32 ms;
    849 MB -> 0.25 ms. wikipedia: ~5 us.

The backward sums dW over all 19,200 patch rows. Blocks cannot carry that
sum across a grid as the Pallas kernel does, so it is a deterministic
two-pass reduction (``csrc/weight_grad.cuh``): partial sums per row chunk
into scratch this wrapper allocates, then a fixed-order sum; two runs give
identical gradients.

What the simple design leaves on the table: f32 FMAs on CUDA cores where
TF32 or bf16 tensor cores (wgmma) would make it purely bytes-bound; x
could be gathered straight from the feature tables inside the kernel
instead of from a gathered (M, Lp, D) copy; the 64-wide column tile wastes
14 of 64 lanes at ced = 50.
"""
from __future__ import annotations

import torch

from . import _build

_NAME = "patch_projection"
_ARGTYPES = [_build.P] * 2 + [_build.I] * 2 + [_build.P] * 2 + [_build.I] * 3 + [_build.P]
_BWD_ARGTYPES = [_build.P] * 4 + [_build.I] * 4 + [_build.P]


def _flat(x: torch.Tensor, patch: int, compute_dtype: torch.dtype) -> torch.Tensor:
    m, lp, d = x.shape
    xf = x.reshape(m * (lp // patch), patch * d)
    return xf if compute_dtype == torch.float32 else xf.to(compute_dtype).float()


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
    m, lp, _ = x.shape
    xf = _flat(x, patch, compute_dtype)
    if compute_dtype != torch.float32:
        w = w.to(compute_dtype).float()
    return (xf @ w + bias).reshape(m, lp // patch, -1)


def patch_projection_backward_plain(
    x: torch.Tensor,
    dout: torch.Tensor,
    patch: int,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dW (patch*D, ced), dbias (ced,)) for dout (M, Lp // patch, ced).

    ``compute_dtype=torch.bfloat16`` rounds x and dout to bf16 for dW, the
    math of the JAX kernel's ``_bwd_kernel``; dbias sums dout in f32.
    """
    g = dout.reshape(-1, dout.shape[-1])
    gm = g if compute_dtype == torch.float32 else g.to(compute_dtype).float()
    return _flat(x, patch, compute_dtype).t() @ gm, g.sum(0)


def _check(x, w, bias, patch):
    m, lp, d = x.shape
    ced = w.shape[-1]
    if patch < 1 or lp % patch:
        raise ValueError(f"sequence length {lp} is not a multiple of patch {patch}")
    f32, dev = torch.float32, x.device
    _build.require(x, "x", f32, (m, lp, d), dev)
    _build.require(bias, "bias", f32, (ced,), dev)
    return _build.require_weight(w, "w", f32, (patch * d, ced), dev)


def _forward_kernel(x, w, bias, patch):
    w_sk, w_sn = _check(x, w, bias, patch)
    m, lp, d = x.shape
    ced = w.shape[-1]
    rows = m * (lp // patch)
    out = torch.empty((rows, ced), dtype=torch.float32, device=x.device)
    lib = _build.load(_NAME, "patch_projection_forward", _ARGTYPES)
    rc = lib.patch_projection_forward(
        x.data_ptr(), w.data_ptr(), w_sk, w_sn, bias.data_ptr(), out.data_ptr(), rows,
        patch * d, ced, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    patch_projection.launches += 1
    return out.view(m, lp // patch, ced)


def patch_projection_backward(
    x: torch.Tensor, dout: torch.Tensor, patch: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (M, Lp, D) f32, dout (M, Lp // patch, ced) f32 ->
    (dW (patch*D, ced), dbias (ced,)).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if x.device.type == "cpu":
        return patch_projection_backward_plain(x, dout, patch)
    if x.device.type != "cuda":
        raise ValueError(f"patch_projection_backward: unsupported device {x.device}")
    m, lp, d = x.shape
    if patch < 1 or lp % patch:
        raise ValueError(f"sequence length {lp} is not a multiple of patch {patch}")
    rows, k = m * (lp // patch), patch * d
    ced = dout.shape[-1]
    f32, dev = torch.float32, x.device
    _build.require(x, "x", f32, (m, lp, d), dev)
    _build.require(dout, "dout", f32, (m, lp // patch, ced), dev)
    chunk = _build.weight_grad_chunk_rows(rows, k, ced)
    dw_ext = torch.empty((k + 1, ced), dtype=f32, device=dev)
    partial = torch.empty((max(1, -(-rows // chunk)), k + 1, ced), dtype=f32, device=dev)
    lib = _build.load(_NAME, "patch_projection_backward", _BWD_ARGTYPES)
    rc = lib.patch_projection_backward(
        x.data_ptr(), dout.data_ptr(), dw_ext.data_ptr(), partial.data_ptr(), rows, k, ced,
        chunk, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, f"{_NAME} backward")
    patch_projection_backward.launches += 1
    return dw_ext[:k], dw_ext[k]


class _PatchProjection(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, patch):
        ctx.patch = patch
        ctx.save_for_backward(x)
        if x.device.type == "cpu":
            return patch_projection_plain(x, w, bias, patch)
        return _forward_kernel(x, w, bias, patch)

    @staticmethod
    def backward(ctx, dout):
        (x,) = ctx.saved_tensors
        dw, dbias = patch_projection_backward(x, dout.contiguous(), ctx.patch)
        return None, dw, dbias, None


def patch_projection(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, patch: int
) -> torch.Tensor:
    """x (M, Lp, D) f32; w (patch*D, ced); bias (ced,) -> (M, Lp // patch, ced).

    ``w`` may be row-major or the transpose of nn.Linear's (ced, patch*D)
    weight; the kernel reads either in place. Differentiable in ``w`` and
    ``bias`` (not in ``x``). CPU tensors take the plain versions; CUDA
    tensors launch the kernels.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"patch_projection: unsupported device {x.device}")
    return _PatchProjection.apply(x, w, bias, patch)


patch_projection.launches = 0
patch_projection_backward.launches = 0
