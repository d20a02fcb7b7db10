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
ced = 50), each input read once and each output written once, bytes
against 3.35 TB/s:
  * forward, CanParl (Lp = 2048, patch 64): 851 MB -> 0.254 ms. Its 21.1 G
    operations take 0.315 ms at the 67 T/s f32 CUDA-core peak, so a
    CUDA-core kernel could not reach the memory floor; the kernel's three
    TF32 passes, 63 G operations, take 0.128 ms at the 495 T/s tensor-core
    peak, so the bound is the bytes. wikipedia (Lp = 32, patch 1): 17 MB ->
    5.1 us.
  * backward, CanParl: 849 MB -> 0.254 ms (CUDA cores 0.32 ms, tensor cores
    0.13). wikipedia: ~5 us.

What bounds the kernels, and what the design does about it
(``csrc/patch_gemm.cuh``): x is streamed once through a 4-stage cp.async
ring (16-byte copies where its row stride and address allow, else 4
bytes), multiplied on the tensor cores (mma.sync m16n8k8) in split TF32:
each operand v = hi + lo, both TF32, and lo*hi + hi*lo + hi*hi summed in
f32, which keeps f32 accuracy (one TF32 pass misses the port's 1e-4
agreement at K = 11,008; ``tests/test_torch_patch_projection.py`` shows
both). ced = 50 is padded to 56 with zeros in shared memory only. The
reduction is split so that the grid fills the card: the forward splits K
(``forward_plan``, which also picks blocks of 128 or 64 rows), the
backward its rows (``backward_chunk_rows``), into partial sums that this
wrapper allocates and a second pass adds in a fixed order, so two runs
give identical bits.

The bf16 variant (``compute_dtype=torch.bfloat16``, a DyGFormer built
with ``compute_dtype="bfloat16"``; ``csrc/patch_projection_bf16.cu``):
the same tiles, ring and splits with one bf16 mma.sync m16n8k16 pass
(``csrc/bf16_mma.cuh``), the JAX kernels' math (bf16 x and W, f32 sums).
x is bf16 (half the bytes: 423 MB at CanParl, 0.126 ms) and the output is
bf16, rounded as the JAX package's bf16 frozen channel rounds it
(``TorchLinear(dtype=bfloat16)``: the product to bf16, then its sum with
the bias rounded to bf16); the backward reads bf16 x and the bf16 dout
and returns f32 dW and dbias. Its launches count apart, under
``patch_projection_bf16`` and ``patch_projection_bf16_bwd`` in
``ops.launch_counts()``.

Left on the table: x could be gathered straight from the feature tables
inside the kernel instead of from a gathered (M, Lp, D) copy; a
warp-specialised TMA + wgmma pipeline would spend fewer instructions per
byte than mma.sync with fragments loaded one register at a time.
"""
from __future__ import annotations

import torch

from . import _build
from ._plan import STAGES, TILE_K, TILE_N, best_plan, sm_count

_NAME = "patch_projection"
_ARGTYPES = [_build.P] * 2 + [_build.I] * 2 + [_build.P] * 3 + [_build.I] * 7 + [_build.P]
_BWD_ARGTYPES = [_build.P] * 4 + [_build.I] * 6 + [_build.P]
_BF16_NAME = "patch_projection_bf16"
# the bf16 variant's launches (it has no wrapper of its own)
BF16_FORWARD, BF16_BACKWARD = _build.LaunchCounter(), _build.LaunchCounter()
# csrc/patch_gemm.cuh: the mma rows a block may own (4 or 2 warps of 32;
# x rows in the forward, K entries in the backward, which takes 128 only:
# at the wikipedia shapes 64 measured faster in the forward and slower in
# the backward, scripts/time_patch_projection.py); a stage is TILE_K deep
# (K in the forward, rows in the backward)
TILE_MS, BWD_TILE_MS = (128, 64), (128,)


def copy_floats(t: torch.Tensor, row_stride: int) -> int:
    """Floats per cp.async copy of ``t``'s rows (row stride in elements):
    4, 2 or 1, the widest whose byte size divides both the row stride and
    the address (16-byte copies need a 16-byte aligned pointer and
    ``row_stride % 4 == 0``)."""
    for v in (4, 2, 1):
        if row_stride % v == 0 and t.data_ptr() % (4 * v) == 0:
            return v
    raise ValueError("the kernel reads f32 rows: the tensor is not 4-byte aligned")


def copy_values(t: torch.Tensor, row_stride: int) -> int:
    """bf16 values per copy of ``t``'s rows (row stride in elements): 8, 4
    or 2 by cp.async, the widest whose byte size divides both the row
    stride and the address; 1 (a plain load) where neither allows 4 bytes."""
    for v in (8, 4, 2):
        if row_stride % v == 0 and t.data_ptr() % (2 * v) == 0:
            return v
    return 1


def forward_plan(rows: int, k: int, ced: int, sms: int) -> tuple[int, int]:
    """(rows per block, K per split) of the forward; K per split is a
    multiple of TILE_K and the forward runs ceil(k / it) splits."""
    tile_m, per = best_plan(max(rows, 1), ced, max(1, -(-k // TILE_K)), rows * ced, sms,
                            TILE_MS)
    return tile_m, per * TILE_K


def backward_chunk_rows(rows: int, k: int, ced: int, sms: int) -> int:
    """Rows per partial sum of the backward (blocks of 128 K entries), a
    multiple of TILE_K; it runs ceil(rows / them) chunks."""
    _, per = best_plan(k + 1, ced, max(1, -(-rows // TILE_K)), (k + 1) * ced, sms, BWD_TILE_MS)
    return per * TILE_K


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
    round_output: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version, with the JAX signature.

    ``compute_dtype=torch.bfloat16`` rounds the matmul operands to bf16 and
    accumulates in f32, the math of the JAX oracle
    ``patch_projection_reference``; with ``round_output`` it also rounds
    as the bf16 variant does (the JAX package's bf16 frozen channel): the
    product to bf16, then its sum with the bias rounded to bf16, a bf16
    result.
    """
    m, lp, _ = x.shape
    xf = _flat(x, patch, compute_dtype)
    if compute_dtype != torch.float32:
        w = w.to(compute_dtype).float()
    if round_output:
        out = (xf @ w).to(compute_dtype) + bias.to(compute_dtype)
    else:
        out = xf @ w + bias
    return out.reshape(m, lp // patch, w.shape[-1])


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
    if compute_dtype != torch.float32:  # the bf16 variant's dout is bf16: f32 sums
        g = g.float()
    gm = g if compute_dtype == torch.float32 else g.to(compute_dtype).float()
    return _flat(x, patch, compute_dtype).t() @ gm, g.sum(0)


def _check(x, w, bias, patch, x_dtype):
    m, lp, d = x.shape
    ced = w.shape[-1]
    if patch < 1 or lp % patch:
        raise ValueError(f"sequence length {lp} is not a multiple of patch {patch}")
    f32, dev = torch.float32, x.device
    _build.require(x, "x", x_dtype, (m, lp, d), dev)
    _build.require(bias, "bias", f32, (ced,), dev)
    return _build.require_weight(w, "w", f32, (patch * d, ced), dev)


def _check_compute_dtype(compute_dtype):
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"patch_projection: compute dtype {compute_dtype} is not float32 or "
                         "bfloat16")


def _forward_kernel(x, w, bias, patch, compute_dtype):
    """The split-TF32 forward kernel (f32 x and output), or in bf16 the
    bf16 variant's (bf16 x and output)."""
    bf16, dtype = compute_dtype == torch.bfloat16, compute_dtype
    w_sk, w_sn = _check(x, w, bias, patch, dtype)
    m, lp, d = x.shape
    ced = w.shape[-1]
    rows, k = m * (lp // patch), patch * d
    out = torch.empty((rows, ced), dtype=dtype, device=x.device)
    tile_m, k_chunk = forward_plan(rows, k, ced, sm_count(x.device))
    splits = -(-k // k_chunk)
    partial = (torch.empty((splits, rows, ced), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    # W: K-major (nn.Linear's weight.t()) is copied in rows of K, a
    # row-major W float by float, transposed (w_vec 0)
    w_vec = copy_floats(w, w_sn) if w_sk == 1 else 0
    name, entry, wrapper, x_vec = (
        (_BF16_NAME, "patch_projection_bf16_forward", BF16_FORWARD, copy_values(x, k)) if bf16
        else (_NAME, "patch_projection_forward", patch_projection, copy_floats(x, k)))
    lib = _build.load(name, entry, _ARGTYPES)
    rc = getattr(lib, entry)(
        x.data_ptr(), w.data_ptr(), w_sk, w_sn, bias.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), rows, k, ced, tile_m, k_chunk,
        x_vec, w_vec, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, name)
    _build.count_launch(wrapper)
    return out.view(m, lp // patch, ced)


def _backward_kernel(x, dout, patch, compute_dtype):
    """The split-TF32 backward kernel (f32 x and dout), or in bf16 the bf16
    variant's (bf16 x and dout); f32 gradients either way."""
    m, lp, d = x.shape
    if patch < 1 or lp % patch:
        raise ValueError(f"sequence length {lp} is not a multiple of patch {patch}")
    rows, k = m * (lp // patch), patch * d
    ced = dout.shape[-1]
    f32, dev = torch.float32, x.device
    bf16, dtype = compute_dtype == torch.bfloat16, compute_dtype
    _build.require(x, "x", dtype, (m, lp, d), dev)
    _build.require(dout, "dout", dtype, (m, lp // patch, ced), dev)
    if (k + 1) * ced >= 2**31:
        raise ValueError(f"dW has {(k + 1) * ced} elements; the kernels index with int32")
    chunk = backward_chunk_rows(rows, k, ced, sm_count(dev))
    chunks = -(-rows // chunk)
    dw_ext = torch.empty((k + 1, ced), dtype=f32, device=dev)
    partial = torch.empty((chunks, k + 1, ced), dtype=f32, device=dev) if chunks > 1 else None
    vec = copy_values if bf16 else copy_floats
    name, entry, wrapper = (
        (_BF16_NAME, "patch_projection_bf16_backward", BF16_BACKWARD) if bf16
        else (_NAME, "patch_projection_backward", patch_projection_backward))
    lib = _build.load(name, entry, _BWD_ARGTYPES)
    rc = getattr(lib, entry)(
        x.data_ptr(), dout.data_ptr(), dw_ext.data_ptr(),
        None if partial is None else partial.data_ptr(), rows, k, ced, chunk,
        vec(x, k), vec(dout, ced), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, f"{name} backward")
    _build.count_launch(wrapper)
    return dw_ext[:k], dw_ext[k]


def patch_projection_backward(
    x: torch.Tensor, dout: torch.Tensor, patch: int,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (M, Lp, D) f32, dout (M, Lp // patch, ced) f32 ->
    (dW (patch*D, ced), dbias (ced,)); ``compute_dtype=torch.bfloat16``:
    the bf16 variant's, x and dout bf16, dW and dbias f32 sums.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check_compute_dtype(compute_dtype)
    if x.device.type == "cpu":
        return patch_projection_backward_plain(x, dout, patch, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"patch_projection_backward: unsupported device {x.device}")
    return _backward_kernel(x, dout, patch, compute_dtype)


class _PatchProjection(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, patch, compute_dtype):
        ctx.patch, ctx.compute_dtype = patch, compute_dtype
        ctx.save_for_backward(x)
        if x.device.type == "cpu":
            return patch_projection_plain(x, w, bias, patch, compute_dtype,
                                          round_output=compute_dtype == torch.bfloat16)
        return _forward_kernel(x, w, bias, patch, compute_dtype)

    @staticmethod
    def backward(ctx, dout):
        (x,) = ctx.saved_tensors
        dw, dbias = patch_projection_backward(x, dout.contiguous(), ctx.patch, ctx.compute_dtype)
        return None, dw, dbias, None, None


def patch_projection(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, patch: int,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """x (M, Lp, D) f32; w (patch*D, ced); bias (ced,) -> (M, Lp // patch, ced).

    ``w`` may be row-major or the transpose of nn.Linear's (ced, patch*D)
    weight; the kernel reads either in place. Differentiable in ``w`` and
    ``bias`` (not in ``x``). CPU tensors take the plain versions; CUDA
    tensors launch the kernels. ``compute_dtype=torch.bfloat16`` takes the
    bf16 variant: x bf16, a bf16 output (see the module docstring).
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"patch_projection: unsupported device {x.device}")
    _check_compute_dtype(compute_dtype)
    return _PatchProjection.apply(x, w, bias, patch, compute_dtype)


patch_projection.launches = patch_projection.captured = 0
patch_projection_backward.launches = patch_projection_backward.captured = 0
