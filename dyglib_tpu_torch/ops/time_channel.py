"""Fused time-channel patch projection for DyGFormer (CUDA, ``csrc/time_channel.cu``).

    out = patches(where(valid, cos(dt[..., None] * tw + tb), 0)) @ w + bias

Replaces ``dyglib_tpu/ops/pallas/time_channel.py``: ``_fwd_kernel``
(forward) and ``_bwd_kernel`` (backward; the slot-batched variants run only
under the JAX package's ``TC_SLOT`` > 1, off by default). The masked Phi
tensor (M, L, Dt) is computed tile by tile in shared memory and contracted
at once; it never reaches device memory, in either direction.
``time_channel_projection`` is a ``torch.autograd.Function``: on CUDA
tensors its forward and backward launch the two kernels, on CPU tensors
they run the plain versions below. Gradients flow to tw, tb, w and bias;
dt and valid are data.

Bounds on one H100 (M = 600 rows of the B = 200 triple, Dt = 100,
ced = 50), each input read once and each output written once, bytes
against 3.35 TB/s:
  * forward, CanParl (L = 2048, patch 64): 11.3 MB -> 3.4 us. Its product,
    19,200 x 6400 x 50, is 12.3 G operations, 0.184 ms on the f32 CUDA
    cores (67 T/s); the kernel runs it on the tensor cores in three TF32
    passes, 36.9 G operations, 0.0745 ms at 495 T/s. Its 98 M cosines
    (the valid positions) take 0.023 ms at the SFU's 16 a clock per SM.
    Bound by the tensor-core operations. wikipedia (L = 32, patch 1):
    19,200 x 100 x 50, 0.6 G operations on the tensor cores, 1.2 us.
  * backward, CanParl: two (19200 x 6400 x 50) products, 24.6 G
    operations, 0.37 ms on the CUDA cores; in three TF32 passes 73.7 G,
    0.149 ms at 495 T/s; its 98 M (cosine, sine) pairs 0.047 ms at the
    SFU's rate; 13 MB -> 4 us. Bound by the tensor-core operations.
    wikipedia: 1.2 G tensor operations -> 2.3 us.

The forward (``csrc/time_channel.cu``): the product on the tensor cores
(mma.sync) in split TF32, as the patch projection's
(``csrc/patch_gemm.cuh``): every operand v = hi + lo, three passes, f32
sums, which keeps f32 accuracy (one TF32 pass misses the port's 1e-4
agreement at K = 6400; ``tests/test_torch_time_channel_forward.py`` shows
both). Phi is computed in registers, each thread the elements its A
fragment holds, one patch slot at a time with Dt padded to a multiple of
8 (DT_STEP), and never reaches shared or device memory; W streams through
shared memory. The cosine (``csrc/cos_reduced.cuh``) is cosf's, so Phi
is the plain version's bit for bit, without cosf's slow path (a
Payne-Hanek reduction above |theta| = 105615, which the streams' large dt
reach): there it reduces the argument by pi/2 in double. K is split where
that fills the card (``forward_plan``), into partial sums added in a fixed
order: two runs give identical bits. What it leaves on the table: at
CanParl the mma.sync products alone take ~0.35 ms and the cosines ~0.19
more (PERF.md), 7x the bound; wgmma with Phi staged through shared memory,
or fewer registers for more warps an SM, are the next steps.

The bf16 variants (``compute_dtype=torch.bfloat16``, a DyGFormer built
with ``compute_dtype="bfloat16"``) keep the JAX kernels' math: Phi, W (and
dout in the backward) rounded to bf16 with f32 sums; the output and the
gradients are f32, as the JAX kernel's. Both are kernels of their own on
Hopper's wgmma. The backward (``csrc/time_channel_bf16_bwd.cuh``) puts a
block's 128 entries of K on the M side of both products: dPhi^T (64
entries x 64 rows a warpgroup) = W dout^T from shared memory, whose
accumulators are, pair for pair, the register A fragment of dW = Phi^T
dout, so one theta gives -sin for c and cos for Phi packed into A; one
bf16 dout tile (a producer warpgroup converts the f32 rows into the
128-byte swizzle, a stage ahead) is read K-major by the first product and
MN-major by the second; each block takes cosf's fast path, or the double
reduction where its bound needs it, for all its warps. Entries are
unpadded (``bf16_entry_pad``), rows chunked by ``wgmma_backward_plan``;
three launches a call as before (the kernel and the two fixed-order sums).
The forward (``csrc/time_channel.cu``,
``csrc/wgmma.cuh``): W converted to bf16 once a launch and streamed by
TMA (where a split is two stages at most, ``resident_weight``, each block
converts its W into its ring instead: wikipedia's one launch), Phi
computed in registers straight into wgmma's A fragment (A from registers)
while the previous k-step's wgmma runs; each patch slot padded to a
multiple of 16 (BF16_DT_STEP), K split by ``wgmma_forward_plan``.
Bounds at CanParl: the forward's 12.3 G operations take 0.012 ms at 989
T/s, its cosines 0.023 ms at the SFU's rate (bound by the cosines, which
here are cos_reduced's instructions on the CUDA cores: PERF.md gives that
floor too); the backward's 24.6 G operations 0.025 ms, its 98 M (cosine,
sine) pairs 0.047 ms at the SFU's rate (K unpadded: the bound's entry
count is the plain version's), and what the card spends is the CUDA
cores' instructions per (entry, row) pair (``scripts/time_bwd_split.py``
counts them). Their launches count apart, under ``time_channel_bf16`` and
``time_channel_bf16_bwd`` in ``ops.launch_counts()``.

The f32 backward (``csrc/time_channel_bwd.cuh``, which the Phi projection's
backward shares without the mask and dbias) is one kernel for both of its
products, dW_ext = [Phi | 1]^T dout and dPhi = dout W^T, in the same split
TF32: a block owns 128 padded K entries and reduces over a chunk of rows
(``backward_chunk_rows``), each thread's (row, entry) pairs the same in
its dW operand and its dPhi accumulator, so that one reduced argument
gives Phi and -sin(theta) (``csrc/cos_reduced.cuh``: cosf's and -sinf's
values, no slow path); dPhi never leaves registers, its epilogue sums c =
dPhi * -sin and c * dt per entry. Blocks cannot carry a sum across a grid
as the Pallas kernel does, so the row chunks' partial sums go to scratch
this wrapper allocates and second passes add them in a fixed order: two
runs give identical gradients. What it leaves on the table: mma.sync with
fragments loaded register by register (wgmma is the next step), and the
trigonometry on the FMA pipes.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from ._plan import _GRID_Z_LIMIT, STAGES, TILE_K, TILE_N, WGMMA_STAGE_K, best_plan, sm_count
from .patch_projection import copy_floats, packed_weight_shape

_NAME = "time_channel"
_ARGTYPES = [_build.P] * 5 + [_build.I] * 2 + [_build.P] * 3 + [_build.I] * 6 + [_build.P]
_BF16_ARGTYPES = [_build.P] * 5 + [_build.I] * 2 + [_build.P] * 4 + [_build.I] * 6 + [_build.P]
# csrc/time_channel.cu: rows of a forward block, padded K entries of a
# backward block, and the mma k-step to which each patch slot's Dt
# features are padded
TILE_M, BWD_ENTRIES, DT_STEP = 128, 128, 8
# shared memory one block may take on an H100
_SMEM_LIMIT = 232_448
_BWD_ARGTYPES = [_build.P] * 5 + [_build.I] * 2 + [_build.P] * 5 + [_build.I] * 7 + [_build.P]
# the bf16 forward's patch slots: Dt padded to the bf16 mma's depth
BF16_DT_STEP = 16
# the bf16 variants' launches (they have no wrapper of their own)
BF16_FORWARD, BF16_BACKWARD = _build.LaunchCounter(), _build.LaunchCounter()
# csrc/time_channel_bf16_bwd.cuh: a block's K entries, rows a stage,
# columns a tile, the patch slots its entries may span, and its blocks on
# an SM (384 threads of up to 168 registers)
BF16_BWD_ENTRIES, BF16_BWD_ROWS, BF16_BWD_COLS, BF16_BWD_MAX_SLOTS = 128, 64, 64, 8
BF16_BWD_BLOCKS_PER_SM = 1
# the bf16 backward's chunk plan: a chunk's partial sums ((K + 1) * ced f32
# written and read back) cost this many 64-row stages of a block a MB
_BF16_BWD_CHUNK_STAGES_PER_MB = 0.15
# csrc/time_channel.cu: the bf16 forward's block rows (two warpgroups of 64)
# and its blocks on an SM (288 threads of at most 112 registers)
BF16_TILE_M, BF16_BLOCKS_PER_SM = 128, 2
# the wgmma forward's split plan in units of one 64-deep stage of a block
# (8,192 cosines): a split's partial sums (rows * ced f32 written and read
# back) cost this many stages a MB; with it the plan picks 5 splits at
# CanParl, where the card's sweep is flat from 5 to 7
# (scripts/kernel_turns.py --sweep, PERF.md). Fitted at CanParl alone: at
# wikipedia's two stages one split wins for any weight
_BF16_SPLIT_STAGES_PER_MB = 0.15


def _theta(dt, tw, tb):
    return dt[..., None] * tw + tb


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
    phi = torch.where(valid[..., None] != 0, torch.cos(_theta(dt, tw, tb)), 0.0)
    x = phi.reshape(m * p, patch * tw.shape[-1])
    if compute_dtype != torch.float32:
        x, w = x.to(compute_dtype).float(), w.to(compute_dtype).float()
    return (x @ w + bias).reshape(m, p, w.shape[-1])


def time_channel_backward_plain(
    dt: torch.Tensor,
    valid: torch.Tensor,
    tw: torch.Tensor,
    tb: torch.Tensor,
    w: torch.Tensor,
    dout: torch.Tensor,
    patch: int,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dtw (Dt,), dtb (Dt,), dW (patch*Dt, ced), dbias (ced,)) for dout
    (M, L // patch, ced), by the explicit formulas:

        dW = Phi^T @ dout,  dbias = sum dout,  dPhi = dout @ W^T,
        dtb = sum where(valid, -dPhi * sin(theta), 0),  dtw = same * dt

    ``compute_dtype=torch.bfloat16`` rounds Phi, dout and W to bf16 for the
    two products, the math of the JAX kernel's ``_bwd_kernel``.
    """
    m, l = dt.shape
    dt_dim = tw.shape[-1]
    theta = _theta(dt, tw, tb)
    mask = valid[..., None] != 0
    phi = torch.where(mask, torch.cos(theta), 0.0).reshape(-1, patch * dt_dim)
    g = dout.reshape(-1, dout.shape[-1])
    gm = g
    if compute_dtype != torch.float32:
        phi, gm, w = (a.to(compute_dtype).float() for a in (phi, g, w))
    dphi = (gm @ w.t()).reshape(m, l, dt_dim)
    common = torch.where(mask, dphi * -torch.sin(theta), 0.0)
    dtw = (common * dt[..., None]).sum((0, 1))
    return dtw, common.sum((0, 1)), phi.t() @ gm, g.sum(0)


def _check(dt, valid, tw, tb, w, patch):
    m, l = dt.shape
    dt_dim = tw.shape[0]
    ced = w.shape[-1]
    if patch < 1 or l % patch:
        raise ValueError(f"sequence length {l} is not a multiple of patch {patch}")
    f32, dev = torch.float32, dt.device
    for t, name, dtype, shape in (
        (dt, "dt", f32, (m, l)), (valid, "valid", torch.bool, (m, l)),
        (tw, "tw", f32, (dt_dim,)), (tb, "tb", f32, (dt_dim,)),
    ):
        _build.require(t, name, dtype, shape, dev)
    return _build.require_weight(w, "w", f32, (patch * dt_dim, ced), dev)


def padded_dt(dt_dim: int, step: int = DT_STEP) -> int:
    """A patch slot's features in the forward kernel: Dt rounded up to a
    multiple of the mma k-step (``BF16_DT_STEP`` in the bf16 variant), so
    that no k-step straddles two slots."""
    return -(-dt_dim // step) * step


def forward_plan(rows: int, patch: int, dt_dim: int, ced: int, sms: int,
                 step: int = DT_STEP) -> int:
    """Padded K (patch * padded_dt(dt_dim, step)) per split of the forward,
    a multiple of TILE_K; the forward runs ceil(padded K / it) splits. The
    split that least loads the busiest SM, by the patch projection's cost
    model (``ops/_plan.py::best_plan``, 128-row blocks): a
    block's stages plus the ring's fill, and the partial sums' traffic."""
    depth = max(1, -(-patch * padded_dt(dt_dim, step) // TILE_K))
    _, per = best_plan(max(rows, 1), ced, depth, rows * ced, sms, (TILE_M,))
    return per * TILE_K


@functools.lru_cache(maxsize=256)
def wgmma_split(out_tiles: int, depth: int, slots: int, split_cost: float) -> int:
    """Stages per split of the bf16 forward: ``out_tiles`` blocks reduce
    over ``depth`` stages, ``slots`` blocks are resident on the card at
    once. The count that least loads the busiest slot: its waves of units
    (``per`` stages plus the ring's fill of STAGES - 1, a stage the unit
    of cost), plus ``split_cost`` stages for each split where there is
    more than one (the partial sums written and read back). Ties go to
    fewer splits.

    Unlike the patch projection's plan (``patch_projection.py::
    wgmma_forward_plan``), which only spreads x's bytes over enough SMs,
    this one counts waves: the time channel's work is its cosines, which
    each block computes for its own rows and K, so a split that adds a wave
    adds its time, while the patch projection's blocks share one memory
    bound that more blocks do not raise."""
    best = None
    for splits in range(1, min(depth, _GRID_Z_LIMIT) + 1):
        per = -(-depth // splits)
        if -(-depth // per) != splits:  # the same split as a smaller count
            continue
        waves = -(-(out_tiles * splits) // slots)
        cost = waves * (per + STAGES - 1) + (splits * split_cost if splits > 1 else 0.0)
        if best is None or cost < best[0]:
            best = (cost, per)
    return best[1]


def wgmma_forward_plan(rows: int, patch: int, dt_dim: int, ced: int, sms: int) -> int:
    """Padded K (patch * padded_dt(dt_dim, BF16_DT_STEP)) per split of the
    bf16 forward on wgmma, a multiple of WGMMA_STAGE_K; it runs ceil(padded
    K / it) splits. ``wgmma_split`` in stages of a block (its cosines are
    the work), a split's partial sums (rows * ced f32, written and read
    back) weighed by _BF16_SPLIT_STAGES_PER_MB."""
    kp = patch * padded_dt(dt_dim, BF16_DT_STEP)
    tiles = -(-max(rows, 1) // BF16_TILE_M) * -(-ced // TILE_N)
    return WGMMA_STAGE_K * wgmma_split(
        tiles, max(1, -(-kp // WGMMA_STAGE_K)), sms * BF16_BLOCKS_PER_SM,
        _BF16_SPLIT_STAGES_PER_MB * rows * ced * 8 / 1e6)


def resident_weight(k_chunk: int) -> bool:
    """Whether the bf16 forward's blocks convert their share of W into
    their ring themselves (a split of two stages at most: wikipedia's 112
    padded K), so that the wrapper packs no bf16 W^T and launches one
    kernel (``csrc/time_channel.cu``, ``kResident``)."""
    return k_chunk <= 2 * WGMMA_STAGE_K


def forward_smem_bytes(dt_dim: int, step: int = DT_STEP) -> int:
    """Dynamic shared memory of a forward block: the ring of W stages
    (TILE_N columns x TILE_K + 4 floats) and tw, tb padded; the bf16
    forward's (``step`` BF16_DT_STEP): its alignment slack, ring of bf16 W
    boxes and barriers, and each step's largest |tw| and |tb|
    (``csrc/time_channel.cu::bf16_forward_smem``)."""
    dt_pad = padded_dt(dt_dim, step)
    if step == BF16_DT_STEP:  # and each k16 step's largest |tw| and |tb|
        return 1024 + STAGES * 8192 + 2 * STAGES * 8 + 4 * 2 * (dt_pad + dt_pad // step)
    return 4 * STAGES * TILE_N * (TILE_K + 4) + 4 * 2 * dt_pad


def _check_compute_dtype(compute_dtype):
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"time_channel: compute dtype {compute_dtype} is not float32 or "
                         "bfloat16")


def _forward_kernel(dt, valid, tw, tb, w, bias, patch, compute_dtype):
    w_sk, w_sn = _check(dt, valid, tw, tb, w, patch)
    m, l = dt.shape
    dt_dim, ced, dev = tw.shape[0], w.shape[-1], dt.device
    _build.require(bias, "bias", torch.float32, (ced,), dev)
    bf16 = compute_dtype == torch.bfloat16
    step = BF16_DT_STEP if bf16 else DT_STEP
    if forward_smem_bytes(dt_dim, step) > _SMEM_LIMIT:
        raise ValueError(f"Dt = {dt_dim}: tw and tb do not fit one block's shared memory")
    rows = m * (l // patch)
    dt_pad = padded_dt(dt_dim, step)
    if bf16:
        return _forward_bf16(dt, valid, tw, tb, w, bias, patch, (w_sk, w_sn))
    out = torch.empty((rows, ced), dtype=torch.float32, device=dev)
    k_chunk = forward_plan(rows, patch, dt_dim, ced, sm_count(dev), step)
    splits = -(-patch * dt_pad // k_chunk)
    partial = (torch.empty((splits, rows, ced), dtype=torch.float32, device=dev)
               if splits > 1 and rows > 0 else None)
    entry = "time_channel_forward"
    lib = _build.load(_NAME, entry, _ARGTYPES)
    rc = getattr(lib, entry)(
        dt.data_ptr(), valid.data_ptr(), tw.data_ptr(), tb.data_ptr(), w.data_ptr(), w_sk,
        w_sn, bias.data_ptr(), out.data_ptr(), None if partial is None else partial.data_ptr(),
        rows, patch, dt_dim, dt_pad, ced, k_chunk, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, entry)
    _build.count_launch(time_channel_projection)
    return out.view(m, l // patch, ced)


def _forward_bf16(dt, valid, tw, tb, w, bias, patch, w_strides, k_chunk=None):
    """The bf16 forward on wgmma; the arguments checked by the caller.
    ``k_chunk`` overrides the plan's split (a multiple of WGMMA_STAGE_K)."""
    m, l = dt.shape
    dt_dim, ced, dev = tw.shape[0], w.shape[-1], dt.device
    rows, dt_pad = m * (l // patch), padded_dt(dt_dim, BF16_DT_STEP)
    if k_chunk is None:
        k_chunk = wgmma_forward_plan(rows, patch, dt_dim, ced, sm_count(dev))
    splits = -(-patch * dt_pad // k_chunk)
    partial = (torch.empty((splits, rows, ced), dtype=torch.float32, device=dev)
               if splits > 1 and rows > 0 else None)
    out = torch.empty((rows, ced), dtype=torch.float32, device=dev)
    w16 = (None if resident_weight(k_chunk) else
           torch.empty(packed_weight_shape(ced, patch * dt_pad), dtype=torch.bfloat16, device=dev))
    entry = "time_channel_bf16_forward"
    lib = _build.load(_NAME, entry, _BF16_ARGTYPES)
    rc = getattr(lib, entry)(
        dt.data_ptr(), valid.data_ptr(), tw.data_ptr(), tb.data_ptr(), w.data_ptr(), *w_strides,
        bias.data_ptr(), out.data_ptr(), None if partial is None else partial.data_ptr(),
        None if w16 is None else w16.data_ptr(), rows, patch, dt_dim, dt_pad, ced, k_chunk,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, entry)
    _build.count_launch(BF16_FORWARD)
    return out.view(m, l // patch, ced)


def backward_chunk_rows(rows: int, patch: int, dt_dim: int, ced: int, sms: int) -> int:
    """Rows per partial sum of the backward, a multiple of TILE_K; it runs
    ceil(rows / them) chunks. Its blocks own BWD_ENTRIES of the padded K
    entries (patch * padded_dt(dt_dim)) and TILE_N columns; the chunk
    count is the one that least loads the busiest SM by
    ``ops/_plan.py::best_plan``, the partial sums of dW, dtw and dtb
    counted."""
    k = patch * dt_dim
    depth = max(1, -(-rows // TILE_K))
    _, per = best_plan(patch * padded_dt(dt_dim), ced, depth, (k + 1) * ced + 2 * k, sms,
                       (BWD_ENTRIES,))
    return per * TILE_K


def bf16_entry_pad(dt_dim: int) -> int:
    """The bf16 backward's entry layout: each patch slot's Dt features
    this many entries apart. Unpadded (Dt itself) where a block's
    BF16_BWD_ENTRIES entries span at most BF16_BWD_MAX_SLOTS slots (Dt >=
    19); below that, Dt padded to a multiple of 16 (16 or 32), whose slots
    a block spans evenly."""
    if (BF16_BWD_ENTRIES - 1) // dt_dim + 2 <= BF16_BWD_MAX_SLOTS:
        return dt_dim
    return padded_dt(dt_dim, BF16_DT_STEP)


def wgmma_backward_plan(rows: int, patch: int, dt_dim: int, ced: int, sms: int,
                        dt_pad: int | None = None) -> int:
    """Rows per chunk of the bf16 backward, a multiple of BF16_BWD_ROWS;
    it runs ceil(rows / them) chunks. ``wgmma_split`` over its blocks
    (entry tiles x 64-column tiles) and 64-row stages, one block an SM, a
    chunk's partial sums ((K + 1) * ced f32 written and read back) weighed
    by _BF16_BWD_CHUNK_STAGES_PER_MB."""
    dt_pad = bf16_entry_pad(dt_dim) if dt_pad is None else dt_pad
    tiles = -(-patch * dt_pad // BF16_BWD_ENTRIES) * -(-ced // BF16_BWD_COLS)
    stages = max(1, -(-rows // BF16_BWD_ROWS))
    partial_mb = (patch * dt_dim + 1) * ced * 8 / 1e6
    return BF16_BWD_ROWS * wgmma_split(tiles, stages, sms * BF16_BWD_BLOCKS_PER_SM,
                                       _BF16_BWD_CHUNK_STAGES_PER_MB * partial_mb)


def time_channel_backward(
    dt: torch.Tensor,
    valid: torch.Tensor,
    tw: torch.Tensor,
    tb: torch.Tensor,
    w: torch.Tensor,
    dout: torch.Tensor,
    patch: int,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward's arguments (no bias) and dout (M, L // patch, ced) f32
    -> (dtw (Dt,), dtb (Dt,), dW (patch*Dt, ced), dbias (ced,));
    ``compute_dtype=torch.bfloat16``: the bf16 variant's (Phi, dout and W
    rounded to bf16 for both products; dtw, dtb and dbias f32 sums).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check_compute_dtype(compute_dtype)
    if dt.device.type == "cpu":
        return time_channel_backward_plain(dt, valid, tw, tb, w, dout, patch, compute_dtype)
    if dt.device.type != "cuda":
        raise ValueError(f"time_channel_backward: unsupported device {dt.device}")
    return _backward_kernel(dt, valid, tw, tb, w, dout, patch, compute_dtype)


def _backward_kernel(dt, valid, tw, tb, w, dout, patch, compute_dtype):
    w_sk, w_sn = _check(dt, valid, tw, tb, w, patch)
    m, l = dt.shape
    dt_dim, ced = tw.shape[0], w.shape[-1]
    if dt_dim < 1:
        raise ValueError("time_channel_backward: the kernel takes at least one time feature")
    k = patch * dt_dim
    _build.require(dout, "dout", torch.float32, (m, l // patch, ced), dt.device)
    if (k + 1) * ced >= 2**31:
        raise ValueError(f"dW has {(k + 1) * ced} elements; the kernels index with int32")
    if compute_dtype == torch.bfloat16:
        return _backward_bf16(dt, valid, tw, tb, w, dout, patch, (w_sk, w_sn))
    rows = m * (l // patch)
    chunk = backward_chunk_rows(rows, patch, dt_dim, ced, sm_count(dt.device))
    return _launch_backward("time_channel_backward", time_channel_backward, dt, valid, tw, tb,
                            w, (w_sk, w_sn), dout, patch, padded_dt(dt_dim), chunk, TILE_N)


def _backward_bf16(dt, valid, tw, tb, w, dout, patch, w_strides, chunk_rows=None, dt_pad=None):
    """The bf16 backward on wgmma; the arguments checked by the caller.
    ``chunk_rows`` (a multiple of BF16_BWD_ROWS) and ``dt_pad`` (at least
    Dt, spanning at most BF16_BWD_MAX_SLOTS slots a block) override the
    plan's."""
    m, l = dt.shape
    dt_dim, ced = tw.shape[0], w.shape[-1]
    dt_pad = bf16_entry_pad(dt_dim) if dt_pad is None else dt_pad
    if chunk_rows is None:
        chunk_rows = wgmma_backward_plan(m * (l // patch), patch, dt_dim, ced,
                                         sm_count(dt.device), dt_pad)
    return _launch_backward("time_channel_bf16_backward", BF16_BACKWARD, dt, valid, tw, tb, w,
                            w_strides, dout, patch, dt_pad, chunk_rows, BF16_BWD_COLS)


def _launch_backward(entry, counter, dt, valid, tw, tb, w, w_strides, dout, patch, dt_pad,
                     chunk, tile_cols):
    """One backward entry point: its scratch (the row chunks' partial dW,
    the dtw and dtb sums per chunk, column tile and slot) and its launch."""
    m, l = dt.shape
    dt_dim, ced, f32, dev = tw.shape[0], w.shape[-1], torch.float32, dt.device
    rows, k = m * (l // patch), patch * dt_dim
    chunks, col_tiles = max(1, -(-rows // chunk)), max(1, -(-ced // tile_cols))
    new = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    dw_ext, dt_grads = new(k + 1, ced), new(2, dt_dim)
    partial = new(chunks, k + 1, ced) if chunks > 1 else None
    part = new(chunks * col_tiles * patch, 2, dt_dim)  # dtw's and dtb's sums
    lib = _build.load(_NAME, entry, _BWD_ARGTYPES)
    rc = getattr(lib, entry)(
        dt.data_ptr(), valid.data_ptr(), tw.data_ptr(), tb.data_ptr(), w.data_ptr(), *w_strides,
        dout.data_ptr(), dw_ext.data_ptr(), dt_grads.data_ptr(),
        None if partial is None else partial.data_ptr(), part.data_ptr(), rows, patch, dt_dim,
        dt_pad, ced, chunk, copy_floats(dout, ced), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, entry)
    _build.count_launch(counter)
    return dt_grads[0], dt_grads[1], dw_ext[:k], dw_ext[k]


class _TimeChannel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dt, valid, tw, tb, w, bias, patch, compute_dtype):
        ctx.patch, ctx.compute_dtype = patch, compute_dtype
        ctx.save_for_backward(dt, valid, tw, tb, w)
        if dt.device.type == "cpu":
            return time_channel_projection_plain(dt, valid, tw, tb, w, bias, patch, compute_dtype)
        return _forward_kernel(dt, valid, tw, tb, w, bias, patch, compute_dtype)

    @staticmethod
    def backward(ctx, dout):
        dt, valid, tw, tb, w = ctx.saved_tensors
        dtw, dtb, dw, dbias = time_channel_backward(
            dt, valid, tw, tb, w, dout.contiguous(), ctx.patch, ctx.compute_dtype
        )
        return None, None, dtw, dtb, dw, dbias, None, None


def time_channel_projection(
    dt: torch.Tensor,
    valid: torch.Tensor,
    tw: torch.Tensor,
    tb: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    patch: int,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """dt (M, L) f32, valid (M, L) bool; tw, tb (Dt,); w (patch*Dt, ced);
    bias (ced,) -> (M, L // patch, ced) f32.

    ``w`` may be row-major or the transpose of nn.Linear's (ced, patch*Dt)
    weight; the kernels read either in place. Differentiable in tw, tb, w
    and bias. CPU tensors take the plain versions; CUDA tensors launch the
    kernels. ``compute_dtype=torch.bfloat16`` takes the bf16 variants.
    """
    if dt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"time_channel_projection: unsupported device {dt.device}")
    _check_compute_dtype(compute_dtype)
    return _TimeChannel.apply(dt, valid, tw, tb, w, bias, patch, compute_dtype)


time_channel_projection.launches = time_channel_projection.captured = 0
time_channel_backward.launches = time_channel_backward.captured = 0
