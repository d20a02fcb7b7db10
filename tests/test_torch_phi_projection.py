"""The Phi projection kernels' arithmetic, on the CPU.

The CUDA forward (``csrc/phi_projection.cu``) computes out = cos(dt * tw +
tb) @ w on the tensor cores in split TF32: every operand v = hi + lo, hi =
tf32(v) rounded to nearest, lo = v - hi read truncated to TF32, and per
8-deep k-step of the padded depth lo*hi + hi*lo + hi*hi, all of it one
sum over the whole depth; each Phi element is computed once with the
cosine of ``csrc/cos_reduced.cuh``. The backward is the time channel's
backward kernel at patch 1 without its mask and dbias
(``csrc/time_channel_bwd.cuh``), with the Phi projection's row chunks.
Both are emulated with numpy by the helpers of
``tests/test_torch_time_channel_forward.py`` (the cosine, the TF32 split)
and ``tests/test_torch_time_channel_backward.py`` (the backward's order of
sums), and held to:
  * the port's f32 plain versions (``phi_projection_plain``: 1e-5;
    ``phi_projection_backward_plain``: GRAD_RTOL / 10 of each entry's sum
    of |terms|; the card holds the kernels to 1e-4 and GRAD_RTOL = 3e-5),
    with dt up to 1e6 (|theta| past 105615, the double reduction), W
    contiguous and as the strided rows of nn.Linear's weight transposed;
  * the JAX package's Phi projection in f32 (the formula of
    ``phi_projection_reference``, its dot at full f32 precision; the
    oracle itself rounds to bf16) and ``jax.vjp`` of it, within the same
    tolerances, dt up to 100 (at dt ~ 1e6 one rounding of theta is a
    difference of Phi, and XLA may fuse the multiply and add that PyTorch
    and the kernels round twice);
  * one TF32 pass, which misses 1e-4 at TGAT's widths (Dt = 100, Dq = 272,
    W at nn.Linear's initialisation): the reason for three.
The wrapper's plans are tested here too; the kernels run only on the card
(``tests/test_torch_cuda_kernels.py``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu_torch import ops

pp = importlib.import_module("dyglib_tpu_torch.ops.phi_projection")
fwd = importlib.import_module("tests.test_torch_time_channel_forward")
bwd = importlib.import_module("tests.test_torch_time_channel_backward")

F = np.float32
H100_SMS = 132
KERNEL_ATOL = 1e-4
FEAT = 344  # the feature columns before W's Phi rows in TGAT's kv (two 172-wide rows)
# TGAT's layer 1: hop 1 (600 x 20 x 20 kv rows) and hop 0 / layer 2 (600 x 20)
TGAT_ROWS = (240_000, 12_000)


def _case(seed, r, dt_dim, dq, dt_scale, layout):
    """dt integer gaps up to dt_scale, the encoder's spectrum tw =
    10^-linspace(0, 9), tb ~ 0.1 N(0, 1), W the Phi rows of an nn.Linear
    (FEAT + Dt -> Dq) weight at its initialisation U(+-(FEAT + Dt)^-1/2):
    as given (``rows``, contiguous) or read through the transposed weight
    (``linear_slice``, a strided view), dout ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    dt = np.floor(rng.rand(r) * dt_scale).astype(F)
    tw = (1.0 / 10 ** np.linspace(0, 9, dt_dim)).astype(F)
    tb = (rng.randn(dt_dim) * 0.1).astype(F)
    kv = FEAT + dt_dim
    weight = rng.uniform(-(kv**-0.5), kv**-0.5, (dq, kv)).astype(F)
    w = np.ascontiguousarray(weight.T[FEAT:])
    dout = rng.randn(r, dq).astype(F)
    w_t = torch.from_numpy(w) if layout == "rows" else torch.from_numpy(weight).t()[FEAT:]
    return (dt, tw, tb, w, dout), w_t


def emulated_forward(dt, tw, tb, w, passes=3):
    """The forward kernel's arithmetic: Phi from the kernel's cosine (theta
    rounded twice), the depth padded to a multiple of 8 with zeros in W,
    one f32 sum over every k-step of lo*hi, hi*lo, hi*hi (or hi*hi
    alone)."""
    dt_dim, dq = w.shape
    dt_pad = pp.padded_dt(dt_dim)
    theta = (dt[:, None] * tw).astype(F) + tb  # two f32 roundings, no FMA
    a = np.zeros((dt.shape[0], dt_pad), F)
    a[:, :dt_dim] = fwd.cos_reduced(theta)
    b = np.zeros((dt_pad, dq), F)
    b[:dt_dim] = w
    a_hi, a_lo = fwd.split(a)
    b_hi, b_lo = fwd.split(b)
    acc = np.zeros((dt.shape[0], dq), F)
    for s in range(0, dt_pad, 8):
        sl = slice(s, s + 8)
        if passes == 3:
            acc = acc + a_lo[:, sl] @ b_hi[sl]
            acc = acc + a_hi[:, sl] @ b_lo[sl]
        acc = acc + a_hi[:, sl] @ b_hi[sl]
    return acc


def emulated_backward(dt, tw, tb, w, dout):
    """(dtw, dtb, dw): the time channel's backward emulation at patch 1,
    every position valid, with the Phi projection's row chunks (its dbias
    is not computed by the Phi kernel)."""
    rows, dt_dim, dq = dt.shape[0], tw.shape[0], w.shape[1]
    chunk = pp.backward_chunk_rows(rows, dt_dim, dq, H100_SMS)
    valid = np.ones((rows, 1), bool)
    dtw, dtb, dw, _ = bwd.emulated_backward(dt[:, None], valid, tw, tb, w, dout[:, None], 1,
                                            chunk_rows=chunk)
    return dtw, dtb, dw


def _plain(dt, tw, tb, w_t):
    return ops.phi_projection_plain(torch.from_numpy(dt), torch.from_numpy(tw),
                                    torch.from_numpy(tb), w_t).numpy()


def _plain_backward(dt, tw, tb, w, dout, abs_terms=False):
    args = [torch.from_numpy(x) for x in (dt, tw, tb, w, dout)]
    return [x.numpy() for x in ops.phi_projection_backward_plain(*args, abs_terms=abs_terms)]


def _jax_f32(dt, tw, tb, w):
    """phi_projection_reference's formula, its dot in f32."""
    phi = jnp.cos(jnp.asarray(dt)[:, None] * jnp.asarray(tw) + jnp.asarray(tb))
    return np.asarray(jnp.dot(phi, jnp.asarray(w), precision=jax.lax.Precision.HIGHEST))


def _jax_f32_vjp(dt, tw, tb, w, dout):
    """jax.vjp of that formula in (tw, tb, w)."""
    def projection(tw_, tb_, w_):
        phi = jnp.cos(jnp.asarray(dt)[:, None] * tw_ + tb_)
        return jnp.dot(phi, w_, precision=jax.lax.Precision.HIGHEST)

    _, vjp = jax.vjp(projection, jnp.asarray(tw), jnp.asarray(tb), jnp.asarray(w))
    return [np.asarray(x) for x in vjp(jnp.asarray(dout))]


def _assert_within(got, want, terms, rtol):
    for name, a, b, t in zip(("dtw", "dtb", "dw"), got, want, terms):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        excess = (np.abs(a - b) - rtol * t).max()
        assert excess <= 1e-30, f"{name}: exceeds {rtol} x sum|terms| by {excess}"


# (seed, R, Dt, Dq, layout): TGAT's widths (Dt 100, Dq 272: five column
# tiles, the last ragged), Dt 6 (one k-step) and 101 (padded to 104, a
# ragged last step), Dq 50 (one ragged tile) and 137 (three); both layouts
CASES = [
    (0, 300, 100, 272, "rows"),
    (1, 1000, 100, 272, "linear_slice"),
    (2, 300, 6, 50, "linear_slice"),
    (3, 1000, 101, 137, "rows"),
]


@pytest.mark.parametrize("seed,r,dt_dim,dq,layout", CASES)
def test_emulated_forward_matches_plain_f32(seed, r, dt_dim, dq, layout):
    (dt, tw, tb, w, _), w_t = _case(seed, r, dt_dim, dq, 1e6, layout)
    assert np.abs((dt[:, None] * tw)).max() > fwd.SMALL_LIMIT  # the double reduction
    emu = emulated_forward(dt, tw, tb, w)
    plain = _plain(dt, tw, tb, w_t)
    assert emu.shape == plain.shape == (r, dq)
    np.testing.assert_allclose(emu, plain, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed,r,dt_dim,dq,layout", CASES)
def test_emulated_forward_matches_jax_f32(seed, r, dt_dim, dq, layout):
    (dt, tw, tb, w, _), _ = _case(seed, r, dt_dim, dq, 1e2, layout)
    np.testing.assert_allclose(emulated_forward(dt, tw, tb, w), _jax_f32(dt, tw, tb, w),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed,r,dt_dim,dq,layout", CASES)
def test_emulated_backward_matches_plain_f32(seed, r, dt_dim, dq, layout):
    arrays, _ = _case(seed, r, dt_dim, dq, 1e6, layout)
    _assert_within(emulated_backward(*arrays), _plain_backward(*arrays),
                   _plain_backward(*arrays, abs_terms=True), bwd.EMU_RTOL)


@pytest.mark.parametrize("seed,r,dt_dim,dq,layout", CASES)
def test_emulated_backward_matches_jax_f32_vjp(seed, r, dt_dim, dq, layout):
    arrays, _ = _case(seed, r, dt_dim, dq, 1e2, layout)
    _assert_within(emulated_backward(*arrays), _jax_f32_vjp(*arrays),
                   _plain_backward(*arrays, abs_terms=True), bwd.EMU_RTOL)


def test_one_tf32_pass_misses_the_kernel_tolerance():
    """At TGAT's widths one TF32 pass is over the 1e-4 agreement the card
    holds the kernel to; the three-pass split is two orders of magnitude
    inside it."""
    (dt, tw, tb, w, _), w_t = _case(4, 1000, 100, 272, 1e6, "rows")
    plain = _plain(dt, tw, tb, w_t)
    one = np.abs(emulated_forward(dt, tw, tb, w, passes=1) - plain).max()
    three = np.abs(emulated_forward(dt, tw, tb, w) - plain).max()
    assert one > KERNEL_ATOL
    assert three < KERNEL_ATOL / 100


# ---- the wrapper's plans


def _walked_row_tiles(rows, row_blocks):
    """The m16 row tiles each warp of a group's row walkers visits, in the
    kernel's order: warp w of block x takes x * FWD_WARPS + w, then steps
    by row_blocks * FWD_WARPS."""
    m_tiles = -(-rows // 16)
    step = row_blocks * pp.FWD_WARPS
    return [list(range(x * pp.FWD_WARPS + w, m_tiles, step))
            for x in range(row_blocks) for w in range(pp.FWD_WARPS)]


@pytest.mark.parametrize("rows,dt_dim,dq", [
    (TGAT_ROWS[0], 100, 272), (TGAT_ROWS[1], 100, 272), (1, 100, 272), (300, 6, 50),
    (1000, 101, 137), (12_000, 100, 50), (240_000, 100, 560), (5000, 1000, 8),
])
def test_forward_plan_covers_every_row_and_column(rows, dt_dim, dq):
    """Every row tile visited by one warp exactly once, no block without a
    row tile, every column in one group and no group empty, at most
    MAX_TILES tiles a group, and a block's shared memory within the card's."""
    tiles, groups, row_blocks = pp.forward_plan(rows, dt_dim, dq, H100_SMS)
    assert 1 <= tiles <= pp.MAX_TILES and row_blocks >= 1
    cols = tiles * pp.TILE_N
    assert groups * cols >= dq > (groups - 1) * cols
    walked = _walked_row_tiles(rows, row_blocks)
    assert sorted(t for w in walked for t in w) == list(range(-(-rows // 16)))
    assert all(any(walked[x * pp.FWD_WARPS + w] for w in range(pp.FWD_WARPS))
               for x in range(row_blocks))
    assert pp.forward_smem_bytes(tiles, dt_dim) <= pp.SMEM_LIMIT == 232_448


@pytest.mark.parametrize("rows", TGAT_ROWS)
def test_forward_plan_fills_the_card_at_tgat_sizes(rows):
    """At both of TGAT's sizes at least one block an SM; at hop 1 one
    column group, so that each cosine is computed once a launch."""
    tiles, groups, row_blocks = pp.forward_plan(rows, 100, 272, H100_SMS)
    assert groups * row_blocks >= H100_SMS
    if rows == TGAT_ROWS[0]:
        assert (tiles, groups) == (5, 1)


def test_forward_plan_raises_where_w_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        pp.forward_plan(100, 1100, 8, H100_SMS)


@pytest.mark.parametrize("dt_dim", [1, 6, 8, 16, 100, 101, 200])
def test_w_stride_makes_fragment_loads_conflict_free(dt_dim):
    """A half warp's 8-byte loads of B (lanes g < 4, t < 4: floats g S + 2t
    and + 1) cover the 32 banks once: S an odd multiple of 8, at least the
    padded depth."""
    s = pp.w_stride(dt_dim)
    assert s >= pp.padded_dt(dt_dim) and s % 16 == 8
    banks = {(g * s + 2 * t + i) % 32 for g in range(4) for t in range(4) for i in range(2)}
    assert len(banks) == 32


@pytest.mark.parametrize("rows,dt_dim,dq", [
    (TGAT_ROWS[0], 100, 272), (TGAT_ROWS[1], 100, 272), (1, 100, 272), (300, 6, 50),
    (1000, 101, 137), (3_000_000, 100, 272),
])
def test_backward_plan_covers_every_row(rows, dt_dim, dq):
    """Whole 32-row stages, every row in one chunk, no empty chunk, a grid
    the card takes (z at most 65535)."""
    chunk = pp.backward_chunk_rows(rows, dt_dim, dq, H100_SMS)
    assert chunk % pp.TILE_K == 0 and chunk > 0
    chunks = -(-rows // chunk)
    assert (chunks - 1) * chunk < rows and chunks <= 65535


@pytest.mark.parametrize("rows", TGAT_ROWS)
def test_backward_plan_fills_the_card_at_tgat_sizes(rows):
    """Dt 100 padded to 104 is one entry tile; its five column tiles are
    split into row chunks until every SM has a block."""
    chunk = pp.backward_chunk_rows(rows, 100, 272, H100_SMS)
    assert 5 * -(-rows // chunk) >= H100_SMS
