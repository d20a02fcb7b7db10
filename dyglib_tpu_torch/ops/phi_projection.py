"""Fused Phi(dt) @ W projection for TGAT (CUDA, ``csrc/phi_projection.cu``).

    out = cos(dt[:, None] * tw + tb) @ w     (R, Dt) @ (Dt, Dq) -> (R, Dq)

Replaces ``dyglib_tpu/ops/pallas/phi_projection.py::phi_projection``: its
forward ``_fwd_kernel`` and its backward ``_bwd_kernel``. A kv row is
[feat || Phi(dt)], so key = feat @ Wk[:Df] + Phi(dt) @ Wk[Df:]: TGAT's
``use_phi_fusion`` computes the second term here, for key and for val, and
the (R, Dt) time features never reach device memory. It is the time
channel of ``csrc/time_channel.cu`` at patch 1 with no mask and no bias:
the same rounding of the argument (``csrc/phi.cuh``) and the same cosine
(``csrc/cos_reduced.cuh``: cosf's bits, and -sinf's in the backward,
without their slow path). No mask: pad rows are handled by the
attention's logits, not here.

``phi_projection`` is a ``torch.autograd.Function``: on CUDA tensors its
forward and backward launch the two kernels, on CPU tensors they run the
plain forward and the explicit plain backward below. dt gets no gradient.

Bounds on one H100 at the TGAT batch (layer 1, hop 1: R = 240,000, Dt =
100, Dq = 272), both products on the tensor cores in three TF32 passes
(split TF32: every operand v = hi + lo, lo*hi + hi*lo + hi*hi, f32 sums,
which keeps f32 agreement; one pass misses the port's 1e-4):
  * forward 2 x 240,000 x 100 x 272 x 3 = 39.2 G operations, 0.079 ms at
    495 T/s; its 261 MB written take 0.078 ms; bound by the operations.
    (On the f32 CUDA cores: 13.1 G operations, 0.196 ms at 67 T/s.)
  * backward two products, 78.3 G operations, 0.158 ms; 261 MB of dout
    read, 0.078 ms; bound by the operations (f32 CUDA cores: 0.39 ms).
  The 24 M (cosine, sine) pairs take ~0.006 ms at the SFU's rate.

The forward: a warp owns 16 rows and every column of its column group,
walks the whole depth computing each Phi element of its A fragment once
and multiplying it into every column; W sits in shared memory, a
persistent grid of about one block an SM walks the row tiles
(``forward_plan``). The backward: the time channel's backward kernel
without mask and dbias (``csrc/time_channel_bwd.cuh``): dW = Phi^T dout
and dPhi = dout W^T in one kernel, Phi and -sin(theta) from one argument
reduction, row chunks (``backward_chunk_rows``) added by a second pass and
dtw, dtb by a third in a fixed order: two runs give identical gradients.

What the design leaves on the table: the (R, Dq) product is written to
device memory and read back by the add of the feature term (fusing both
terms into one kernel is what ``ops/gathered_attention.py`` does); key's
and val's launches compute the same cosines; mma.sync with fragments
loaded register by register (wgmma is the next step).
"""
from __future__ import annotations

import torch

from . import _attention, _build
from ._plan import TILE_K, TILE_N, best_plan, sm_count
from .patch_projection import copy_floats
from .time_channel import padded_dt

_NAME = "phi_projection"
_ARGTYPES = [_build.P] * 4 + [_build.I] * 2 + [_build.P] + [_build.I] * 7 + [_build.P]
_BWD_ARGTYPES = [_build.P] * 4 + [_build.I] * 2 + [_build.P] * 5 + [_build.I] * 6 + [_build.P]
# csrc/phi_projection.cu: warps of a forward block (16 rows each), the
# column tiles of accumulators a warp holds; csrc/time_channel_bwd.cuh:
# warps of a backward block (16 padded entries each)
FWD_WARPS, MAX_TILES, BWD_WARPS = 8, 5, 7
# shared memory one block may take on an H100
SMEM_LIMIT = 232_448
# blocks of the backward kernel that an SM holds at once (its launch bounds)
_BWD_BLOCKS_PER_SM = 2


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


def w_stride(dt_dim: int) -> int:
    """Shared-memory floats a column of W takes in the forward: the padded
    depth rounded up to an odd multiple of 8, so that a warp's 8-byte
    fragment loads hit distinct banks."""
    p = padded_dt(dt_dim)
    return p if (p // 8) % 2 == 1 else p + 8


def forward_smem_bytes(tiles: int, dt_dim: int) -> int:
    """Dynamic shared memory of a forward block of ``tiles`` column tiles:
    W's columns and tw, tb padded."""
    return 4 * (tiles * TILE_N * w_stride(dt_dim) + 2 * padded_dt(dt_dim))


def forward_plan(rows: int, dt_dim: int, dq: int, sms: int) -> tuple[int, int, int]:
    """(column tiles a group, groups, row walkers a group) of the forward.

    A block's FWD_WARPS warps each take one 16-row tile at a time and all
    of its group's columns (at most MAX_TILES tiles of TILE_N: the
    accumulators a thread holds), computing each cosine once a group.
    Where the row tiles fill the card, the fewest groups (one up to
    MAX_TILES tiles, each within a block's shared memory) and about one
    block an SM walking the row tiles: W is staged once a block. Where
    they do not (R = 12,000), a group a column tile and a warp a row tile:
    the small blocks share the SMs, and each computes its rows' cosines
    again (faster there than fewer, larger groups, PERF.md). Raises if one
    column tile of W does not fit a block's shared memory.
    """
    if forward_smem_bytes(1, dt_dim) > SMEM_LIMIT:
        raise ValueError(f"Dt = {dt_dim}: W's columns do not fit one block's shared memory")
    m_tiles = max(1, -(-rows // 16))
    col_tiles = max(1, -(-dq // TILE_N))
    walkers = -(-m_tiles // FWD_WARPS)  # blocks if each warp took one row tile
    tiles = next(per for per in range(min(col_tiles, MAX_TILES), 0, -1)
                 if forward_smem_bytes(per, dt_dim) <= SMEM_LIMIT)
    groups = -(-col_tiles // tiles)
    if walkers * groups < sms:
        return 1, col_tiles, walkers
    return tiles, groups, min(walkers, max(1, -(-sms // groups)))


def backward_chunk_rows(rows: int, dt_dim: int, dq: int, sms: int) -> int:
    """Rows per partial sum of the backward, a multiple of TILE_K; it runs
    ceil(rows / them) chunks. Its blocks own 16 BWD_WARPS padded entries
    and TILE_N columns; the chunk count is the one that least loads the
    busiest of the card's block slots (two blocks an SM) by
    ``ops/_plan.py::best_plan``, the partial sums of dw, dtw and dtb
    counted."""
    depth = max(1, -(-rows // TILE_K))
    _, per = best_plan(padded_dt(dt_dim), dq, depth, dt_dim * dq + 2 * dt_dim,
                       _BWD_BLOCKS_PER_SM * sms, (16 * BWD_WARPS,))
    return per * TILE_K


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
    tiles, _, row_blocks = forward_plan(rows, dt_dim, dq, sm_count(dev))
    out = torch.empty((rows, dq), dtype=torch.float32, device=dev)
    lib = _build.load(_NAME, "phi_projection_forward", _ARGTYPES)
    rc = lib.phi_projection_forward(
        dt.data_ptr(), tw.data_ptr(), tb.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
        out.data_ptr(), rows, dt_dim, padded_dt(dt_dim), w_stride(dt_dim), dq, tiles,
        row_blocks, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    _build.count_launch(phi_projection)
    return out


def phi_projection_backward(dt, tw, tb, w, dout):
    """As ``phi_projection_backward_plain`` (f32): dt (R,) -> (dtw, dtb, dw).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if dt.device.type == "cpu":
        return phi_projection_backward_plain(dt, tw, tb, w, dout)
    if dt.device.type != "cuda":
        raise ValueError(f"phi_projection_backward: unsupported device {dt.device}")
    rows, dt_dim, dq = _check(dt, tw, tb, w)
    if dt_dim < 1:
        raise ValueError("phi_projection_backward: the kernel takes at least one time feature")
    f32, dev = torch.float32, dt.device
    _build.require(dout, "dout", f32, (rows, dq), dev)
    chunk = backward_chunk_rows(rows, dt_dim, dq, sm_count(dev))
    chunks, col_tiles = max(1, -(-rows // chunk)), max(1, -(-dq // TILE_N))
    new = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    dw, dt_grads = new(dt_dim, dq), new(2, dt_dim)
    partial = new(chunks, dt_dim, dq) if chunks > 1 else None
    part = new(chunks * col_tiles, 2, dt_dim)  # dtw's and dtb's sums
    lib = _build.load(_NAME, "phi_projection_backward", _BWD_ARGTYPES)
    rc = lib.phi_projection_backward(
        dt.data_ptr(), tw.data_ptr(), tb.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
        dout.data_ptr(), dw.data_ptr(), dt_grads.data_ptr(),
        None if partial is None else partial.data_ptr(), part.data_ptr(), rows, dt_dim,
        padded_dt(dt_dim), dq, chunk, copy_floats(dout, dq),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, f"{_NAME} backward")
    _build.count_launch(phi_projection_backward)
    return dt_grads[0], dt_grads[1], dw


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
    unit stride (the kernels read w[k, c] at k * stride(0) + c * stride(1))."""
    if w.device != device or w.dtype != torch.float32 or tuple(w.shape) != tuple(shape):
        raise ValueError(
            f"w must be float32 {tuple(shape)} on {device}; got {w.dtype} "
            f"{tuple(w.shape)} on {w.device}"
        )
    if 1 not in w.stride():
        raise ValueError(f"w has strides {w.stride()}; the kernel needs one unit stride")


phi_projection.launches = phi_projection.captured = 0
phi_projection_backward.launches = phi_projection_backward.captured = 0
