"""The time-channel backward kernel's arithmetic, on the CPU.

The CUDA kernel (``csrc/time_channel.cu``, ``time_channel_backward``)
computes both products of the backward in one kernel, in split TF32 on
the tensor cores (every operand v = hi + lo, hi = tf32(v) rounded to
nearest, lo = v - hi read truncated to TF32, lo*hi + hi*lo + hi*hi):

  * dW = Phi^T dout, 8 rows a step, each 32-row stage into fresh
    registers added to the running sum, the row chunks of
    ``backward_chunk_rows`` added by a second pass in a fixed order;
    dbias on the CUDA cores: per chunk, four threads a column each sum
    8 rows of every stage, combined in a fixed order, then the chunks as
    dW's;
  * dPhi = dout W^T, 56 deep (ced 50 padded), one fresh sum per 8-row
    step; c = dPhi * -sin(theta) where valid; per entry, each of a quad's
    four lanes sums c and c * dt (a fused multiply-add) over its rows
    (8 nt + 2 t + b of every stage, in order), the lanes combined by a
    fixed butterfly, the (chunk, column tile, slot) partial sums of each
    feature by a 256-thread block (strided, then a tree).

Phi and -sin come from one argument reduction, ``csrc/cos_reduced.cuh``'s
(the cosine's emulation is ``tests/test_torch_time_channel_forward.py``'s):
-sin(x) is the cosine's polynomial kernel one quadrant on. Here that
arithmetic is emulated with numpy (TF32 rounding by bit masking, the f32
sums in the kernel's order; the products inside one mma.sync as numpy's
f32 matmul). It is held to:
  * float64 sin of the same f32 argument within 2 ulp, for |x| up to 1e9,
    the f32 arguments nearest multiples of pi/2 included;
  * the port's plain f32 backward (``time_channel_backward_plain``) within
    GRAD_RTOL / 10 of each entry's sum of |terms| (the card's checks hold
    the kernel to GRAD_RTOL = 3e-5), at patch 1 and patch > 1, with masked
    rows and with dt up to 1e8 (|theta| past 105615, the double
    reduction);
  * ``jax.vjp`` of the JAX package's projection in f32 (the formula of
    ``time_channel_projection_reference``, its dot at full f32 precision;
    the oracle itself rounds to bf16) within the same tolerance, dt up to
    100 (at dt ~ 1e6 one rounding of theta is a difference of Phi, and XLA
    may fuse the multiply and add that PyTorch and the kernel round
    twice).
The wrapper's plan and the attention backward's shared-memory check are
tested here too; the kernels themselves run only on the card
(``tests/test_torch_cuda_kernels.py``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu_torch import ops
from dyglib_tpu_torch.ops import _attention

tc = importlib.import_module("dyglib_tpu_torch.ops.time_channel")
fwd = importlib.import_module("tests.test_torch_time_channel_forward")

F = np.float32
H100_SMS = 132
GRAD_RTOL = 3e-5
EMU_RTOL = GRAD_RTOL / 10
TILE_N, STAGE_ROWS, STEP = 56, 32, 8


# ---- the reduced sine


def sincos_reduced(x):
    """(cos x, -sin x) as the kernel's sincos_reduced gives them: one
    reduction (cos_large's: the f32 one below 105615, the double one
    above), then the cosine's polynomials at quadrants q and q + 1."""
    x = np.asarray(x, F)
    small = np.abs(x) < fwd.SMALL_LIMIT
    (rs, qs), (rl, ql) = fwd._reduce_small(np.where(small, x, 0)), fwd._reduce_large(x)
    r, q = np.where(small, rs, rl), np.where(small, qs, ql)
    return fwd._quadrant(r, q), fwd._quadrant(r, q + 1)


def _sin_ulps(ms, x):
    want = np.sin(x.astype(np.float64))
    return np.abs(-ms.astype(np.float64) - want) / np.spacing(np.abs(want).astype(F))


@pytest.mark.parametrize("magnitude", [1.0, 1e2, 1e5, 1e6, 1e8, 1e9])
def test_reduced_sine_within_2_ulp(magnitude):
    """-(-sin) within 2 ulp of sin at every size, on both reductions (a
    warp takes the double one for all its arguments when one is large),
    and the cosine from the same reduction is the forward's."""
    rng = np.random.RandomState(10 + int(np.log10(magnitude)))
    x = ((rng.rand(100_000) * 2 - 1) * magnitude).astype(F)
    c, ms = sincos_reduced(x)
    assert _sin_ulps(ms, x).max() <= 2.0
    np.testing.assert_array_equal(c, fwd.cos_large(x))
    small = x[np.abs(x) < fwd.SMALL_LIMIT]
    r, q = fwd._reduce_small(small)
    np.testing.assert_array_equal(fwd._quadrant(r, q + 1), sincos_reduced(small)[1])


def test_reduced_sine_near_multiples_of_half_pi():
    """The f32 arguments nearest n pi/2, where sin is near 0 or +-1 and the
    reduction must keep r's relative accuracy, and 0, tiny and negative
    arguments."""
    n = np.unique(np.concatenate([np.arange(1, 5000),
                                  np.logspace(4, 9.2, 20000).astype(np.int64)]))
    near = (n.astype(np.float64) * (np.pi / 2)).astype(F)
    x = np.concatenate([near, np.nextafter(near, F(np.inf)), np.nextafter(near, F(0)), -near,
                        np.array([1e-30, -1e-7, np.pi / 4, 3 * np.pi / 4], F)])
    assert np.abs(x).max() < 2**40
    assert _sin_ulps(sincos_reduced(x)[1], x).max() <= 2.0
    assert sincos_reduced(np.array([0.0, -0.0], F))[1].tolist() == [0.0, 0.0]


# ---- the backward


def _mm(a, b):
    """One 8-deep mma.sync step's product, f32 (numpy's f32 matmul)."""
    return (a.astype(F) @ b.astype(F)).astype(F)


def _strided_sum(parts):
    """sum over the first axis as weight_grad.cuh's strided_sum adds it:
    lane y adds y, y + lanes, ... in order, then a fixed tree; 256 lanes a
    column where fewer than 132 blocks of 32 columns would cover the
    columns and there are more than 32 rows, else 32."""
    cols = int(np.prod(parts.shape[1:]))
    lanes = 256 if (cols + 31) // 32 < 132 and parts.shape[0] > 32 else 32
    acc = np.zeros((lanes,) + parts.shape[1:], F)
    for i in range(parts.shape[0]):
        acc[i % lanes] = (acc[i % lanes] + parts[i]).astype(F)
    h = lanes // 2
    while h:
        acc[:h] = (acc[:h] + acc[h:2 * h]).astype(F)
        h //= 2
    return acc[0]


def emulated_backward(dt, valid, tw, tb, w, dout, patch, chunk_rows=None):
    """(dtw, dtb, dW, dbias) by the kernel's arithmetic and sum order, the
    rows chunked by ``chunk_rows`` (default: the time channel's plan)."""
    m, l = dt.shape
    dt_dim, ced = tw.shape[0], w.shape[1]
    rows, k = m * (l // patch), patch * dt_dim
    theta = (dt[..., None] * tw).astype(F) + tb  # two f32 roundings, no FMA
    cv, ms = sincos_reduced(theta)
    phi = np.where(valid[..., None], cv, F(0)).reshape(rows, k)
    msin = np.where(valid[..., None], ms, F(0)).reshape(rows, k)
    dte = np.repeat(dt.reshape(rows, patch), dt_dim, axis=1)  # each entry's dt
    tiles = -(-ced // TILE_N)
    g = np.zeros((rows, tiles * TILE_N), F)
    g[:, :ced] = dout.reshape(rows, ced)
    wp = np.zeros((k, tiles * TILE_N), F)
    wp[:, :ced] = w
    a_hi, a_lo = fwd.split(phi)
    g_hi, g_lo = fwd.split(g)
    w_hi, w_lo = fwd.split(wp)
    chunk = chunk_rows or tc.backward_chunk_rows(rows, patch, dt_dim, ced, H100_SMS)
    chunks = -(-rows // chunk)
    dw_parts = np.zeros((chunks, k + 1, tiles * TILE_N), F)
    tw_parts = np.zeros((chunks * tiles, k), F)
    tb_parts = np.zeros((chunks * tiles, k), F)
    for z in range(chunks):
        for y in range(tiles):
            cols = slice(y * TILE_N, (y + 1) * TILE_N)
            acc = np.zeros((k, TILE_N), F)
            s_tw, s_tb = np.zeros((4, k), F), np.zeros((4, k), F)  # lanes t of a quad
            s_bias = np.zeros((4, TILE_N), F)  # row groups of 8
            for r0 in range(z * chunk, min(rows, (z + 1) * chunk), STAGE_ROWS):
                part = np.zeros((k, TILE_N), F)
                for bq in range(4):
                    for r in range(r0 + 8 * bq, r0 + 8 * bq + 8):
                        if r < min(rows, (z + 1) * chunk):
                            s_bias[bq] = (s_bias[bq] + g[r, cols]).astype(F)
                for s0 in range(r0, r0 + STAGE_ROWS, STEP):
                    rs = slice(s0, min(s0 + STEP, rows))
                    if s0 >= rows:
                        break
                    part = part + _mm(a_lo[rs].T, g_hi[rs, cols])
                    part = part + _mm(a_hi[rs].T, g_lo[rs, cols])
                    part = part + _mm(a_hi[rs].T, g_hi[rs, cols])
                    dphi = np.zeros((rs.stop - s0, k), F)
                    for kk in range(y * TILE_N, (y + 1) * TILE_N, STEP):
                        ks = slice(kk, kk + STEP)
                        dphi = dphi + _mm(g_lo[rs, ks], w_hi[:, ks].T)
                        dphi = dphi + _mm(g_hi[rs, ks], w_lo[:, ks].T)
                        dphi = dphi + _mm(g_hi[rs, ks], w_hi[:, ks].T)
                    c = (dphi * msin[rs]).astype(F)
                    for i, r in enumerate(range(s0, rs.stop)):
                        t = (i % STEP) // 2
                        s_tb[t] = (s_tb[t] + c[i]).astype(F)
                        s_tw[t] = fwd.fma32(c[i], dte[r], s_tw[t])
                acc = (acc + part).astype(F)
            dw_parts[z, :k, cols] = acc
            dw_parts[z, k, cols] = ((s_bias[0] + s_bias[1]) + (s_bias[2] + s_bias[3])).astype(F)
            tw_parts[z * tiles + y] = ((s_tw[0] + s_tw[1]) + (s_tw[2] + s_tw[3])).astype(F)
            tb_parts[z * tiles + y] = ((s_tb[0] + s_tb[1]) + (s_tb[2] + s_tb[3])).astype(F)
    if chunks == 1:
        dw = dw_parts[0]
    elif chunks <= 8:  # sum_partials_kernel: in order
        dw = dw_parts[0]
        for z in range(1, chunks):
            dw = (dw + dw_parts[z]).astype(F)
    else:
        dw = _strided_sum(dw_parts)
    # one sum over the (chunk, tile, slot) rows of [dtw's | dtb's] partial sums
    dt_grads = _strided_sum(np.concatenate([tw_parts.reshape(-1, dt_dim),
                                            tb_parts.reshape(-1, dt_dim)], axis=1))
    return dt_grads[:dt_dim], dt_grads[dt_dim:], dw[:k, :ced], dw[k, :ced]


def _case(seed, m, l, patch, dt_dim, ced, dt_scale, masked_rows=0):
    """dt integer gaps up to dt_scale, 20% masked (and whole masked rows),
    the encoder's spectrum tw = 10^-linspace(0, 9), W ~ U(+-K^-1/2) as
    nn.Linear draws it, dout ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    k = patch * dt_dim
    dt = np.floor(rng.rand(m, l) * dt_scale).astype(F)
    valid = rng.rand(m, l) > 0.2
    valid[:masked_rows] = False
    tw = (1.0 / 10 ** np.linspace(0, 9, dt_dim)).astype(F)
    tb = (rng.randn(dt_dim) * 0.1).astype(F)
    w = rng.uniform(-(k**-0.5), k**-0.5, (k, ced)).astype(F)
    dout = rng.randn(m, l // patch, ced).astype(F)
    return dt, valid, tw, tb, w, dout


def _abs_terms(dt, valid, tw, tb, w, dout, patch):
    """Each gradient entry's sum of |terms|, float64."""
    m, l = dt.shape
    dt_dim = tw.shape[0]
    theta = (dt[..., None] * tw).astype(F) + tb
    mask = valid[..., None]
    g = np.abs(dout.reshape(-1, dout.shape[-1])).astype(np.float64)
    phi = np.where(mask, np.abs(np.cos(theta.astype(np.float64))), 0).reshape(g.shape[0], -1)
    dphi = (g @ np.abs(w.astype(np.float64)).T).reshape(m, l, dt_dim)
    common = np.where(mask, dphi * np.abs(np.sin(theta.astype(np.float64))), 0)
    return ((common * np.abs(dt[..., None])).sum((0, 1)), common.sum((0, 1)), phi.T @ g,
            g.sum(0))


def _assert_within(got, want, terms, rtol):
    for name, a, b, t in zip(("dtw", "dtb", "dW", "dbias"), got, want, terms):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        excess = (np.abs(a - b) - rtol * t).max()
        assert excess <= 1e-30, f"{name}: exceeds {rtol} x sum|terms| by {excess}"


def _plain(dt, valid, tw, tb, w, dout, patch):
    args = (*(torch.from_numpy(x) for x in (dt, valid, tw, tb, w, dout)), patch)
    return [x.numpy() for x in ops.time_channel_backward_plain(*args)]


def _jax_f32_vjp(dt, valid, tw, tb, w, dout, patch):
    """jax.vjp of time_channel_projection_reference's formula, its dot in
    f32, in (tw, tb, w, bias)."""
    m, l = dt.shape

    def projection(tw_, tb_, w_, bias_):
        phi = jnp.cos(jnp.asarray(dt)[..., None] * tw_ + tb_)
        phi = phi * jnp.asarray(valid, jnp.float32)[..., None]
        x = phi.reshape(m * (l // patch), patch * tw_.shape[0])
        out = jnp.dot(x, w_, precision=jax.lax.Precision.HIGHEST) + bias_
        return out.reshape(m, l // patch, -1)

    bias = jnp.zeros((w.shape[1],), jnp.float32)
    _, vjp = jax.vjp(projection, jnp.asarray(tw), jnp.asarray(tb), jnp.asarray(w), bias)
    return [np.asarray(x) for x in vjp(jnp.asarray(dout))]


# (seed, M, L, patch, Dt, ced, dt scale, masked rows): patch 1 (wikipedia's
# slot) and 8, 64 (CanParl's K = 6400 on a few rows); Dt 6 and 101
# (padded); ced 130 (three column tiles); dt up to 1e8 (theta past
# 105615); whole masked rows
BWD_CASES = [
    (0, 40, 32, 1, 100, 50, 1e6, 3),
    (1, 7, 12, 4, 6, 9, 1e2, 0),
    (2, 9, 64, 8, 101, 130, 1e8, 2),
    (3, 2, 2048, 64, 100, 50, 1e6, 1),
]


@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced,scale,masked", BWD_CASES)
def test_emulated_backward_matches_plain_f32(seed, m, l, patch, dt_dim, ced, scale, masked):
    arrays = _case(seed, m, l, patch, dt_dim, ced, scale, masked)
    emu = emulated_backward(*arrays, patch)
    _assert_within(emu, _plain(*arrays, patch), _abs_terms(*arrays, patch), EMU_RTOL)


@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced,scale,masked", BWD_CASES)
def test_emulated_backward_matches_jax_f32_vjp(seed, m, l, patch, dt_dim, ced, scale, masked):
    arrays = _case(seed, m, l, patch, dt_dim, ced, 1e2, masked)
    emu = emulated_backward(*arrays, patch)
    _assert_within(emu, _jax_f32_vjp(*arrays, patch), _abs_terms(*arrays, patch), EMU_RTOL)


def test_emulated_backward_all_masked_is_the_bias_gradient():
    """No valid position: dW, dtw and dtb are zero, dbias the sum of dout."""
    dt, valid, tw, tb, w, dout = _case(4, 3, 64, 8, 100, 50, 1e6)
    valid[:] = False
    dtw, dtb, dw, dbias = emulated_backward(dt, valid, tw, tb, w, dout, 8)
    assert not dtw.any() and not dtb.any() and not dw.any()
    np.testing.assert_allclose(dbias, dout.reshape(-1, 50).sum(0), atol=1e-5, rtol=0)


# ---- the wrapper's plan


@pytest.mark.parametrize("rows,patch,dt_dim,ced", [
    (19200, 64, 100, 50), (19200, 1, 100, 50), (0, 1, 6, 9), (1, 64, 100, 50),
    (7, 4, 6, 9), (12, 8, 101, 130), (2, 64, 1, 1), (600 * 64, 32, 100, 57),
    (3_000_000, 1, 100, 50),
])
def test_backward_plan_covers_every_row(rows, patch, dt_dim, ced):
    """Whole 32-row stages, every row in exactly one chunk, no empty chunk,
    a grid the card takes (z at most 65535)."""
    chunk = tc.backward_chunk_rows(rows, patch, dt_dim, ced, H100_SMS)
    assert chunk % tc.TILE_K == 0 and chunk > 0
    chunks = max(1, -(-rows // chunk))
    assert chunks * chunk >= rows and (chunks - 1) * chunk < max(rows, 1)
    assert chunks <= 65535


def test_backward_plan_fills_the_card_at_canparl():
    """CanParl: 6656 padded entries (Dt 100 padded to 104, the dbias entry
    in slot 0's padding) are 52 blocks of 128, under half the card: the
    19,200 rows are split so that every SM has blocks. wikipedia's one
    block of entries is split into many chunks."""
    entries = 64 * tc.padded_dt(100)
    assert entries == 6656 and -(-entries // tc.BWD_ENTRIES) == 52
    chunk = tc.backward_chunk_rows(19200, 64, 100, 50, H100_SMS)
    assert 52 * -(-19200 // chunk) >= H100_SMS
    chunk = tc.backward_chunk_rows(19200, 1, 100, 50, H100_SMS)
    assert -(-19200 // chunk) >= H100_SMS * 3 // 4


# ---- the attention backward's shared memory


@pytest.mark.parametrize("sin_cols,k_max", [(100, 102), (0, 124)])
def test_attention_backward_shared_memory_limit(sin_cols, k_max):
    """``check_shared_memory`` mirrors ``attention_bwd_smem_floats``: at
    the published widths (Dkv 444, 2 heads) a query's K rows, qk and gv,
    four (head, K) rows and, for the gathered and window kernels, K x Dt
    sines fit one block's 227 KB up to K = 102 (124 without sines)."""
    kv, heads = 444, 2
    floats = lambda k: k * kv + 2 * heads * kv + 4 * heads * k + k * sin_cols
    assert 4 * floats(k_max) <= _attention.MAX_SHARED_BYTES < 4 * floats(k_max + 1)
    _attention.check_shared_memory(k_max, kv, heads, backward=True, sin_cols=sin_cols)
    _attention.backward_scratch(1, k_max, kv, 272, heads, "cpu", sin_cols)
    with pytest.raises(ValueError, match="shared memory in the backward kernel"):
        _attention.check_shared_memory(k_max + 1, kv, heads, backward=True, sin_cols=sin_cols)
    with pytest.raises(ValueError, match="shared memory in the backward kernel"):
        _attention.backward_scratch(1, k_max + 1, kv, 272, heads, "cpu", sin_cols)
    # the forward stages no sines: K = k_max + 1 fits it
    _attention.check_shared_memory(k_max + 1, kv, heads, backward=False)
