"""The patch projection kernels' split-TF32 arithmetic, on the CPU.

The CUDA kernels (``csrc/patch_gemm.cuh``) multiply on the tensor cores in
TF32, which keeps 10 explicit mantissa bits. To stay within the port's
kernel-against-plain agreement (1e-4, ``chip_smoke.py`` KERNEL_ATOL) they
split every operand v into hi = tf32(v), rounded to nearest, and lo =
v - hi, which the tensor core reads truncated to TF32, and sum
lo*hi + hi*lo + hi*hi in f32, 8 deep per tensor-core step, each 32-deep
stage into fresh registers that are then added to the running sum; the
reduction is split (K in the forward, rows in the backward) into partial
sums added in order. Here that arithmetic is emulated in plain PyTorch,
with TF32 round-to-nearest (ties away, as ``cvt.rna``) done by bit
masking, and held to:
  * the f32 plain version, float64 and the JAX package's f32 projection
    (its default path, XLA) within 1e-5, at K = 21, 172 and 11,008 (the
    CanParl width, a few hundred rows);
  * one TF32 pass, which misses 1e-4 at K = 11,008: the reason for three;
  * the backward [x | 1]^T @ dout within 3e-6 of each entry's sum of
    |terms| (the card's limit is 3e-5).
The wrapper's Python helpers (copy widths from alignment, the split and
chunk sizes that fill the card) are tested here too; the kernels
themselves run only on the card (``tests/test_torch_cuda_kernels.py``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu_torch import ops

# the module (``ops.patch_projection`` is the wrapper function)
pp = importlib.import_module("dyglib_tpu_torch.ops.patch_projection")
plan = importlib.import_module("dyglib_tpu_torch.ops._plan")

KERNEL_ATOL = 1e-4
H100_SMS = 132


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32, to nearest with ties away from zero: add half a
    TF32 ulp to the magnitude bits, then clear the 13 low mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(t: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor core reads from an f32 register: the 13
    low mantissa bits dropped (rounding toward zero)."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split: hi = tf32(v), to nearest; lo = v - hi as the
    tensor core reads it."""
    hi = tf32(t)
    return hi, tf32_truncated(t - hi)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a (R, K) @ b (K, N) as one kernel block sums it: per 8-deep step
    lo*hi, hi*lo, hi*hi (or hi*hi alone with ``passes=1``) into a stage's
    sum, 32-deep stages added to the running sum."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], pp.TILE_K):
        part = torch.zeros_like(acc)
        for s in range(k0, min(k0 + pp.TILE_K, a.shape[1]), 8):
            sl = slice(s, s + 8)
            if passes == 3:
                part = part + a_lo[:, sl] @ b_hi[sl]
                part = part + a_hi[:, sl] @ b_lo[sl]
            part = part + a_hi[:, sl] @ b_hi[sl]
        acc = acc + part
    return acc


def emulated_forward(x, w, bias, patch, passes=3):
    """The forward kernel's arithmetic: split-K at the wrapper's chunk, the
    splits' partial sums added in order, then the bias."""
    m, lp, d = x.shape
    rows, k = m * (lp // patch), patch * d
    xf = x.reshape(rows, k)
    _, chunk = pp.forward_plan(rows, k, w.shape[1], H100_SMS)
    out = None
    for k0 in range(0, k, chunk):
        part = split_tf32_matmul(xf[:, k0 : k0 + chunk], w[k0 : k0 + chunk], passes)
        out = part if out is None else out + part
    return (out + bias).reshape(m, lp // patch, -1)


def emulated_backward(x, dout, patch):
    """The backward kernel's arithmetic: [x | 1]^T @ dout over row chunks
    of the wrapper's size, the chunks' partial sums added in order."""
    m, lp, d = x.shape
    rows, k = m * (lp // patch), patch * d
    ced = dout.shape[-1]
    a = torch.cat([x.reshape(rows, k), torch.ones((rows, 1))], 1).t()
    g = dout.reshape(rows, ced)
    chunk = pp.backward_chunk_rows(rows, k, ced, H100_SMS)
    ext = None
    for r0 in range(0, rows, chunk):
        part = split_tf32_matmul(a[:, r0 : r0 + chunk], g[r0 : r0 + chunk])
        ext = part if ext is None else ext + part
    return ext[:k], ext[k]


def _case(seed, m, lp, d, patch, ced, scale=1.0):
    """x ~ N(0, scale^2) with the second half of each sequence zero (pad
    rows), W ~ U(+-K^-1/2) as nn.Linear draws it, bias likewise."""
    rng = np.random.RandomState(seed)
    k = patch * d
    x = (scale * rng.randn(m, lp, d)).astype(np.float32)
    x[:, lp // 2 :] = 0.0
    w = rng.uniform(-(k**-0.5), k**-0.5, (k, ced)).astype(np.float32)
    bias = rng.uniform(-(k**-0.5), k**-0.5, ced).astype(np.float32)
    return x, w, bias


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0**-10  # TF32's spacing in [1, 2)
    vals = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2**-23, 1 + 1.5 * ulp, -(1 + ulp / 2), 3.0],
                        dtype=torch.float32)
    want = torch.tensor([1 + ulp, 1.0, 1 + 2 * ulp, -(1 + ulp), 3.0], dtype=torch.float32)
    assert torch.equal(tf32(vals), want)
    r = torch.from_numpy(np.random.RandomState(0).randn(10_000).astype(np.float32) * 1e4)
    hi, lo = split(r)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert ((hi - r).abs() <= r.abs() * 2.0**-11).all()  # half a TF32 ulp
    assert ((hi + lo - r).abs() <= r.abs() * 2.0**-21).all()


# (seed, M, Lp, D, patch, ced): K = 21 (ragged stages and steps), the
# wikipedia K = 172, the CanParl K = 11008 with 256 rows
SPLIT_CASES = [(0, 40, 12, 7, 3, 9), (1, 64, 4, 172, 1, 50), (2, 128, 128, 172, 64, 50)]


@pytest.mark.parametrize("seed,m,lp,d,patch,ced", SPLIT_CASES)
def test_split_tf32_forward_matches_f32(seed, m, lp, d, patch, ced):
    x, w, bias = _case(seed, m, lp, d, patch, ced)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, bias))
    emu = emulated_forward(xt, wt, bt, patch)
    plain = ops.patch_projection_plain(xt, wt, bt, patch)
    rows, k = m * (lp // patch), patch * d
    exact = (x.astype(np.float64).reshape(rows, k) @ w + bias).reshape(m, lp // patch, ced)
    jax_f32 = np.asarray(
        jnp.dot(jnp.asarray(x).reshape(rows, k), jnp.asarray(w),
                precision=jax.lax.Precision.HIGHEST) + jnp.asarray(bias)
    ).reshape(m, lp // patch, ced)
    assert emu.shape == plain.shape == (m, lp // patch, ced)
    np.testing.assert_allclose(emu.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(emu.numpy(), exact, atol=1e-5, rtol=0)
    np.testing.assert_allclose(emu.numpy(), jax_f32, atol=1e-5, rtol=0)


def test_one_tf32_pass_misses_the_kernel_tolerance():
    """At the CanParl width one TF32 pass is ~1e-3 from f32, over the 1e-4
    agreement; the three-pass split is two orders of magnitude inside it."""
    x, w, bias = _case(3, 128, 128, 172, 64, 50)  # 256 rows
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, bias))
    plain = ops.patch_projection_plain(xt, wt, bt, 64)
    one = (emulated_forward(xt, wt, bt, 64, passes=1) - plain).abs().max().item()
    three = (emulated_forward(xt, wt, bt, 64) - plain).abs().max().item()
    assert one > KERNEL_ATOL
    assert three < KERNEL_ATOL / 100


# (seed, M, Lp, D, patch, ced, input scale)
BWD_CASES = [
    (0, 40, 12, 7, 3, 9, 1.0), (1, 64, 4, 172, 1, 50, 1e4), (2, 128, 128, 172, 64, 50, 1.0)
]


@pytest.mark.parametrize("seed,m,lp,d,patch,ced,scale", BWD_CASES)
def test_split_tf32_backward_matches_f32(seed, m, lp, d, patch, ced, scale):
    x, _, _ = _case(seed, m, lp, d, patch, ced, scale)
    dout = np.random.RandomState(seed + 100).randn(m, lp // patch, ced).astype(np.float32)
    xt, gt = torch.from_numpy(x), torch.from_numpy(dout)
    got = emulated_backward(xt, gt, patch)
    want = ops.patch_projection_backward_plain(xt, gt, patch)
    rows = m * (lp // patch)
    g_abs = gt.reshape(rows, ced).abs()
    terms = (xt.reshape(rows, -1).abs().t() @ g_abs, g_abs.sum(0))
    for a, b, t in zip(got, want, terms):
        assert a.shape == b.shape
        assert ((a - b).abs() <= 3e-6 * t + 1e-30).all()


# ---- the wrapper's helpers


def test_copy_floats_follows_alignment():
    flat = torch.zeros(4096, dtype=torch.float32)  # the CPU allocator aligns to 64 bytes
    assert flat.data_ptr() % 16 == 0
    assert pp.copy_floats(flat, 172) == 4
    assert pp.copy_floats(flat[4:], 172) == 4
    assert pp.copy_floats(flat[2:], 172) == 2  # 8-byte aligned
    assert pp.copy_floats(flat[1:], 172) == 1  # 4-byte aligned
    assert pp.copy_floats(flat, 21) == 1  # the row stride decides too
    assert pp.copy_floats(flat, 50) == 2
    x = torch.zeros((10, 15, 7))[1:]  # contiguous, offset 105 floats
    assert x.is_contiguous() and pp.copy_floats(x, 21) == 1


@pytest.mark.parametrize("rows,k,ced", [
    (19200, 11008, 50), (19200, 172, 50), (1, 11008, 50), (0, 21, 9), (5, 1, 1),
    (600 * 512, 688, 50), (33, 14, 7), (3, 1088, 130),
])
def test_plans_are_whole_stages_and_cover_the_reduction(rows, k, ced):
    tile_m, chunk = pp.forward_plan(rows, k, ced, H100_SMS)
    assert tile_m in pp.TILE_MS
    assert chunk % pp.TILE_K == 0 and chunk > 0
    assert 1 <= -(-k // chunk) <= 65535
    assert chunk - pp.TILE_K < k or chunk == pp.TILE_K  # no split is empty
    chunk = pp.backward_chunk_rows(rows, k, ced, H100_SMS)
    assert chunk % pp.TILE_K == 0 and chunk > 0
    assert -(-max(rows, 1) // chunk) <= 65535


def test_plans_fill_the_card_at_canparl():
    """CanParl (19,200 rows, K = 11,008): 150 row tiles of 128 are 1.14
    waves on 132 SMs, so the forward splits K; the backward's 87 tiles of
    K + 1 split the rows into 3 chunks (261 units, two blocks an SM). At
    wikipedia (K = 172) the forward does not split, and takes 64-row
    blocks: 300 of them spread the rows more evenly than 150."""
    tile_m, chunk = pp.forward_plan(19200, 11008, 50, H100_SMS)
    splits = -(-11008 // chunk)
    assert tile_m == 128 and splits > 1 and 150 * splits >= 2 * H100_SMS
    assert pp.backward_chunk_rows(19200, 11008, 50, H100_SMS) == 6400
    tile_m, chunk = pp.forward_plan(19200, 172, 50, H100_SMS)
    assert tile_m == 64 and chunk >= 172


@pytest.mark.parametrize("tile_ms", [pp.TILE_MS, pp.BWD_TILE_MS])
@pytest.mark.parametrize("out_rows,depth", [(19200, 344), (11009, 600), (173, 600), (19200, 6),
                                            (1, 1)])
def test_best_plan_beats_every_other_plan_by_its_cost(out_rows, depth, tile_ms):
    """best_plan returns the block rows and stages per split whose cost
    (the busiest SM's staged bytes with the ring's fill, and the partial
    sums' traffic) is least."""
    partial, cols = out_rows * 50, 50

    def cost(tile_m, per):
        splits = -(-depth // per)
        units = -(-out_rows // tile_m) * -(-cols // pp.TILE_N) * splits
        c = -(-units // H100_SMS) * (per + pp.STAGES - 1) * (tile_m + pp.TILE_N) * pp.TILE_K * 4
        return c + (8 * partial * splits / H100_SMS if splits > 1 else 0)

    tile_m, best = plan.best_plan(out_rows, cols, depth, partial, H100_SMS, tile_ms)
    assert tile_m in tile_ms and 1 <= best <= depth
    assert all(cost(tile_m, best) <= cost(t, per) for t in tile_ms
               for per in range(1, depth + 1))
