"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. They run on the
GPU machine, which has no JAX (so ``tests/conftest.py`` cannot load):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

chip_smoke.py holds each kernel to its plain version at the main path's
shapes; these cases cover the edges those shapes miss: row counts that are
not a multiple of the row tile (none at all, one), ced above one column
tile, K not a multiple of the slice, x that allows only 4- or 8-byte
copies, inputs of magnitude 1e4 (the split-TF32 low parts), keys longer
than one 2048-key hash table, rows on both sides of the co-occurrence
count's all-pairs switch and at the edges of its table sizes, any int32
id, more queries than one 256-thread
block, the time channel's Dt padding (1, 6, 100, 101), ced 1 to 130,
all-masked rows and dt from 0 to 1e8, both weight layouts the
GEMM kernels read (row-major (K, ced) and nn.Linear's (ced, K) transposed),
and the wrappers' refusals; the time channel's backward with every
position masked, theta past 2^40 and Dt 1 to 128; the attention
backwards at K 1, 33 and 96, with every query masked, and with one head
and four; the attention kernels at TGN's and DyRep's shape (M = 600, K =
10), at TGAT's hop 1 (M = 12,000, the per-head products' 128-row blocks)
and at Dkv 443 (their 4-byte copies); the memory models' launches per eval batch and train step; the
reduced cosine and sine bit for bit against torch.cos and torch.sin; the
bf16 forwards (the patch projection's choice of kernel by shape and
address, ced 1 to 130, K split in many, no rows and one row; the time
channel's Dt padding 1 to 101, every row masked) and the bf16 time-channel
backward (0, 1, 63, 65 and 129 rows, ced 1 to 130, Dt 1, 6, 100 and 101,
patch 1 to 64, every position masked, theta past 105615 and 2^40, both
weight layouts).

Tolerances: time_channel and patch_projection atol 1e-4 (both sides are
f32; they differ only in the order of the f32 sums, K <= 11,008 products
of O(1) values, and the time channel's cosine by up to 2 ulp); their
second launches bitwise equal to the first; cooccurrence counts are
integers and must match exactly.
"""
import numpy as np
import pytest
import torch

from dyglib_tpu_torch import ops

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


# (seed, M, L, patch, Dt, ced, dt scale)
TIME_CASES = [
    (0, 7, 12, 4, 6, 9, 1e2),  # ragged everything, K = 24
    (1, 70, 33, 1, 100, 50, 1e6),  # 70 rows: two row tiles, the second ragged
    (2, 9, 64, 8, 100, 130, 1e7),  # ced 130: three column tiles; K = 800
]


def _layout(w: torch.Tensor, layout: str) -> torch.Tensor:
    """w (K, ced) row-major, or the same values as nn.Linear's weight.t()."""
    return w if layout == "rows" else w.t().contiguous().t()


# the forward's edges (csrc/time_channel.cu): ced 1, 7, 50, 57 and 130 (one
# to three 56-column tiles); Dt 1, 6, 100 and 101 (padded to 8, 8, 104 and
# 104); patch 1, 8 and 64 at L = 2048 with a few rows (K split in many);
# no rows and one row; dt 0 everywhere and dt up to 1e8 (theta past cosf's
# fast range, the reduced cosine's); negative tb. (seed, M, L, patch, Dt,
# ced, dt scale, tb shift, masked rows)
TIME_EDGE_CASES = [
    (10, 5, 2048, 64, 100, 50, 1e6, 0.0, 0),  # CanParl's widths, 5 rows: K split
    (11, 3, 2048, 8, 100, 57, 1e8, 0.0, 0),  # a second column tile of one column
    (12, 4, 2048, 1, 6, 7, 1e6, 0.0, 0),  # 8192 rows of K = 6
    (13, 9, 64, 8, 101, 130, 1e8, -3.0, 0),  # Dt 101, three column tiles, tb < 0
    (14, 40, 32, 1, 1, 1, 1e6, 0.0, 0),  # Dt 1, ced 1
    (15, 70, 32, 1, 100, 50, 0.0, 0.0, 0),  # dt 0: theta = tb
    (16, 12, 128, 64, 100, 50, 1e6, 0.0, 12),  # every row masked: the bias
    (17, 20, 64, 8, 100, 50, 1e6, 0.0, 7),  # some rows masked
    (18, 0, 64, 8, 100, 50, 1e6, 0.0, 0),  # no rows
    (19, 1, 32, 1, 100, 50, 1e6, 0.0, 0),  # one row
    (20, 1, 2048, 64, 100, 50, 1e8, 0.0, 0),  # one row at K = 6400
]


def _time_inputs(dev, seed, m, l, patch, dt_dim, ced, scale, tb_shift=0.0, masked_rows=0):
    rng = np.random.RandomState(seed)
    dt = np.floor(rng.rand(m, l) * scale).astype(np.float32)
    valid = rng.rand(m, l) > 0.3
    valid[:masked_rows] = False
    tw = (1.0 / 10 ** np.linspace(0, 9, dt_dim)).astype(np.float32)
    tb = (rng.randn(dt_dim) * 0.1 + tb_shift).astype(np.float32)
    w = (rng.randn(patch * dt_dim, ced) * (patch * dt_dim) ** -0.5).astype(np.float32)
    bias = rng.randn(ced).astype(np.float32)
    return _on(dev, dt, valid, tw, tb, w, bias)


def _check_time_channel(args, m, l, patch, ced):
    """Within ATOL of the plain version, and a second launch bitwise equal
    to the first."""
    before = ops.time_channel_projection.launches
    out = ops.time_channel_projection(*args)
    again = ops.time_channel_projection(*args)
    assert ops.time_channel_projection.launches == before + 2
    ref = ops.time_channel_projection_plain(*args)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (m, l // patch, ced)
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("layout", ["rows", "linear"])
@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced,scale", TIME_CASES)
def test_time_channel_kernel_matches_plain(dev, seed, m, l, patch, dt_dim, ced, scale, layout):
    dt, valid, tw, tb, w, bias = _time_inputs(dev, seed, m, l, patch, dt_dim, ced, scale)
    _check_time_channel((dt, valid, tw, tb, _layout(w, layout), bias, patch), m, l, patch, ced)


@pytest.mark.parametrize("layout", ["rows", "linear"])
@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced,scale,tb_shift,masked", TIME_EDGE_CASES)
def test_time_channel_kernel_edges(dev, seed, m, l, patch, dt_dim, ced, scale, tb_shift,
                                   masked, layout):
    dt, valid, tw, tb, w, bias = _time_inputs(dev, seed, m, l, patch, dt_dim, ced, scale,
                                              tb_shift, masked)
    _check_time_channel((dt, valid, tw, tb, _layout(w, layout), bias, patch), m, l, patch, ced)
    if masked:
        out = ops.time_channel_projection(dt, valid, tw, tb, _layout(w, layout), bias, patch)
        assert torch.equal(out[:masked], bias.expand(masked, l // patch, ced))


# (seed, M, Lp, D, patch, ced, input scale, offset): offset 1 reads x as
# big[1:] of an (M + 1, Lp, D) tensor, contiguous but, where Lp * D is odd,
# only 4-byte aligned
PATCH_CASES = [
    (0, 5, 12, 7, 3, 9, 1.0, 0),  # K = 21: a ragged last K slice
    (1, 70, 32, 172, 1, 50, 1.0, 0),  # K = 172, 16-byte copies
    (2, 11, 64, 17, 64, 100, 1.0, 0),  # K = 1088, ced 100: two column tiles
    (3, 4, 8, 3, 1, 1, 1.0, 0),  # ced 1, K = 3
    (4, 33, 16, 7, 2, 7, 1.0, 0),  # ced 7, K = 14: 8-byte copies
    (5, 40, 16, 43, 4, 56, 1.0, 0),  # ced 56: one full column tile; a ragged row tile
    (6, 130, 4, 172, 1, 57, 1.0, 0),  # ced 57: a second column tile of one column
    (7, 3, 128, 17, 64, 130, 1.0, 0),  # ced 130: three column tiles
    (8, 9, 15, 7, 3, 50, 1.0, 1),  # K = 21 from a 4-byte-aligned x: 4-byte copies
    (9, 0, 8, 5, 2, 50, 1.0, 0),  # no rows
    (10, 1, 64, 172, 64, 50, 1.0, 0),  # one row at K = 11008: many K splits
    (11, 200, 64, 172, 64, 50, 1e4, 0),  # inputs ~1e4: the split's low part
    (12, 600, 128, 172, 64, 50, 1.0, 0),  # 128-row blocks, K split in 13
    (13, 1200, 32, 172, 1, 50, 1.0, 0),  # 128-row blocks, K not split
]


def _patch_input(rng, m, lp, d, offset, scale):
    """x's storage: (M + offset, Lp, D), x = big[offset:]."""
    big = (scale * rng.randn(m + offset, lp, d)).astype(np.float32)
    big[:, lp // 2 :] = 0.0  # zero pad rows, as the gathered sentinel rows are
    return big


@pytest.mark.parametrize("layout", ["rows", "linear"])
@pytest.mark.parametrize("seed,m,lp,d,patch,ced,scale,offset", PATCH_CASES)
def test_patch_projection_kernel_matches_plain(
    dev, seed, m, lp, d, patch, ced, scale, offset, layout
):
    """Within ATOL of the plain f32 version (ATOL x scale for inputs scaled
    up: the same share of the outputs' size), and a second launch
    bitwise equal to the first."""
    rng = np.random.RandomState(seed)
    big = _patch_input(rng, m, lp, d, offset, scale)
    w = (rng.randn(patch * d, ced) * (patch * d) ** -0.5).astype(np.float32)
    bias = rng.randn(ced).astype(np.float32)
    big, w, bias = _on(dev, big, w, bias)
    x = big[offset:]
    assert x.is_contiguous()
    args = (x, _layout(w, layout), bias, patch)
    before = ops.patch_projection.launches
    out = ops.patch_projection(*args)
    again = ops.patch_projection(*args)
    assert ops.patch_projection.launches == before + 2
    ref = ops.patch_projection_plain(*args)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (m, lp // patch, ced)
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, atol=ATOL * scale, rtol=0)


# the bf16 forwards (compute_dtype bfloat16), both on wgmma: the patch
# projection reads x in place where TMA takes its rows (patch * D a
# multiple of 8, x 16-byte aligned), else from a copy in padded rows. (seed,
# M, Lp, D, patch, ced, misaligned): misaligned reads x 2 bytes past a
# 16-byte boundary (TMA refuses the address)
BF16_PATCH_CASES = [
    (20, 5, 16, 12, 4, 9, False),  # K = 48: wgmma, one ragged K stage, ced 9
    (21, 3, 512, 172, 64, 50, False),  # K = 11008, 24 rows: many K splits
    (22, 130, 16, 172, 2, 130, False),  # K = 344, 1040 rows (ragged in 256), ced 130
    (23, 9, 15, 7, 3, 50, False),  # K = 21: padded rows
    (24, 40, 32, 172, 1, 57, False),  # K = 172 (patch 1's rows): padded rows, ced 57
    (25, 4, 16, 12, 4, 50, True),  # K = 48 but x 2-byte aligned: padded rows
    (26, 0, 8, 16, 2, 50, False),  # no rows
    (27, 1, 64, 172, 64, 50, False),  # one row at K = 11008
]
# (seed, M, L, patch, Dt, ced, dt scale, masked rows)
BF16_TIME_CASES = [
    (30, 7, 12, 4, 6, 9, 1e2, 0),  # Dt 6 padded to 16, ced 9
    (31, 5, 2048, 64, 100, 50, 1e6, 0),  # CanParl's widths, 5 rows: K split
    (32, 9, 64, 8, 101, 130, 1e8, 0),  # Dt 101 (112), three column tiles, theta past 1e5
    (33, 40, 32, 1, 1, 1, 1e6, 0),  # Dt 1, ced 1
    (34, 12, 128, 64, 100, 50, 1e6, 12),  # every row masked: the bias
    (35, 0, 64, 8, 100, 50, 1e6, 0),  # no rows
    (36, 1, 32, 1, 100, 50, 1e6, 0),  # one row
    (37, 20, 64, 8, 8, 50, 1e6, 5),  # Dt 8: each slot's upper 8 features padding
    (38, 600, 256, 8, 100, 50, 1e6, 0),  # 19,200 rows: one split of 896 padded K
    (39, 100, 2048, 64, 100, 50, 1e6, 3),  # 3,200 rows of CanParl's K: splits of 768
]
GRAD_RTOL = 3e-5  # chip_smoke.py's share of sum|terms|


def _bf16_ulp(v):
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), torch.frexp(v.float()).exponent - 8)


@pytest.mark.parametrize("seed,m,lp,d,patch,ced,misaligned", BF16_PATCH_CASES)
def test_bf16_patch_forward_kernels_match_plain(dev, seed, m, lp, d, patch, ced, misaligned):
    """The bf16 patch forward on wgmma, x in place or copied to padded rows
    by shape and address, within GRAD_RTOL of sum|terms| plus one bf16 ulp
    of the product and one of the output (two roundings), a second launch
    bitwise equal."""
    import importlib

    pp = importlib.import_module("dyglib_tpu_torch.ops.patch_projection")
    rng = np.random.RandomState(seed)
    k, bf16 = patch * d, torch.bfloat16
    n = m * lp * d
    flat = torch.zeros(n + 16, dtype=bf16, device=dev)
    x = flat[1 : 1 + n] if misaligned else flat[:n]
    x = x.view(m, lp, d)
    x.copy_(torch.from_numpy(rng.randn(m, lp, d).astype(np.float32)).to(dev))
    w, bias = _on(dev, (rng.randn(k, ced) * k**-0.5).astype(np.float32),
                  rng.randn(ced).astype(np.float32))
    w = w.t().contiguous().t()  # nn.Linear's layout, as the model passes it
    xt, ld = pp.tma_rows(x.view(-1, k))
    assert (xt.data_ptr() == x.data_ptr()) == (k % 8 == 0 and not misaligned) and ld % 8 == 0
    ops.reset_launch_counts()
    out = ops.patch_projection(x, w, bias, patch, compute_dtype=bf16)
    again = ops.patch_projection(x, w, bias, patch, compute_dtype=bf16)
    assert {c: v for c, v in ops.launch_counts().items() if v} == {"patch_projection_bf16": 2}
    ref = ops.patch_projection_plain(x, w, bias, patch, bf16, round_output=True)
    x2, w16 = x.reshape(-1, k).float(), w.to(bf16).float()
    prod = (x2 @ w16).view(out.shape)
    terms = (x2.abs() @ w16.abs() + bias.abs()).view(out.shape)
    torch.cuda.synchronize()
    assert out.dtype == bf16 and out.shape == ref.shape == (m, lp // patch, ced)
    assert torch.equal(out, again)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= GRAD_RTOL * terms + _bf16_ulp(prod) + _bf16_ulp(ref)).all())
    assert int((diff > GRAD_RTOL * terms).sum()) <= max(1, out.numel() // 1000)


@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced,scale,masked", BF16_TIME_CASES)
def test_bf16_time_forward_kernel_matches_plain(dev, seed, m, l, patch, dt_dim, ced, scale,
                                                masked):
    """The bf16 time-channel forward on wgmma (W converted in its blocks or
    packed and streamed by TMA: both run here) within GRAD_RTOL of its
    plain bf16 version's sum|terms|, a second launch bitwise equal, the
    bias where every position is masked."""
    dt, valid, tw, tb, w, bias = _time_inputs(dev, seed, m, l, patch, dt_dim, ced, scale,
                                              masked_rows=masked)
    bf16 = torch.bfloat16
    args = (dt, valid, tw, tb, w.t().contiguous().t(), bias, patch)
    ops.reset_launch_counts()
    out = ops.time_channel_projection(*args, compute_dtype=bf16)
    again = ops.time_channel_projection(*args, compute_dtype=bf16)
    assert {c: v for c, v in ops.launch_counts().items() if v} == {"time_channel_bf16": 2}
    ref = ops.time_channel_projection_plain(*args, compute_dtype=bf16)
    phi = torch.where(valid[..., None], torch.cos(dt[..., None] * tw + tb), 0.0)
    phi16 = phi.to(bf16).float().reshape(-1, patch * dt_dim)
    terms = (phi16.abs() @ w.to(bf16).float().abs() + bias.abs()).view(out.shape)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == ref.shape == (m, l // patch, ced)
    assert torch.equal(out, again)
    assert bool(((out - ref).abs() <= GRAD_RTOL * terms).all())
    if masked:
        assert torch.equal(out[:masked], bias.expand(masked, l // patch, ced))


# (seed, R, Lq, Lk, id range)
CO_CASES = [
    (0, 3, 300, 5000, 50),  # Lq over one block, Lk over two key chunks
    (1, 17, 1, 37, 4),  # a single query position
    (2, 5, 2048, 2048, 300),  # the main path's self counts, one full chunk
    (3, 4, 33, 4097, 7),  # Lk one past two chunks
]
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
CO_SWITCH = ops.cooccurrence.ALL_PAIRS_MAX_LK
# the count's edges (csrc/cooccurrence.cu): (seed, R, Lq, Lk, kind), kind
# "one" (one id over the row), "distinct" (no id twice), "extremes"
# (INT32_MIN, INT32_MAX, 0 and negatives) or "pads" (ids 1-49, the second
# half of the row 0); Lk at the edges of the table's sizes (64 keys fill
# 128 slots, 65 take 256), of one table (2048 keys) and on both sides of
# the all-pairs switch (ALL_PAIRS_MAX_LK)
CO_EDGE_CASES = [
    (20, 3, 2048, 2048, "one"),
    (21, 3, 2048, 2048, "distinct"),
    (22, 5, 300, 700, "extremes"),
    (23, 7, 40, 1, "pads"),
    (24, 2, 2047, 2047, "pads"),
    (25, 2, 2049, 2049, "distinct"),
    (26, 2, 100, 20_000, "pads"),
    (27, 2, 100, 20_000, "one"),
    (28, 0, 16, 16, "pads"),
    (29, 1, 2048, 2048, "pads"),
    (30, 9, 64, 64, "extremes"),
    (31, 9, 65, 65, "extremes"),
    (32, 9, 200, 64, "pads"),
    (33, 9, 10, 65, "one"),
    (34, 600, 32, 32, "pads"),  # wikipedia's self launch
    (35, 9, CO_SWITCH, CO_SWITCH, "extremes"),
    (36, 9, CO_SWITCH + 1, CO_SWITCH + 1, "pads"),
    (37, 9, 40, CO_SWITCH + 1, "one"),
]


def _co_ids(rng, r, length, kind):
    if kind == "one":
        return np.full((r, length), INT32_MIN + 3, np.int32)
    if kind == "distinct":
        return np.stack([rng.permutation(length) for _ in range(r)]).reshape(r, length).astype(
            np.int32) * 1009 - 7
    if kind == "extremes":
        pool = np.array([INT32_MIN, INT32_MAX, 0, -1, 1, INT32_MIN + 1, INT32_MAX - 1], np.int32)
        return rng.choice(pool, size=(r, length)).astype(np.int32)
    ids = rng.randint(1, 50, size=(r, length)).astype(np.int32)
    ids[:, length // 2 :] = 0
    return ids


@pytest.mark.parametrize("seed,r,lq,lk,kind", CO_EDGE_CASES)
def test_cooccurrence_kernel_edges(dev, seed, r, lq, lk, kind):
    """Exactly the plain version's counts, for the self launch (q = k,
    where Lq = Lk) and a cross launch (other ids of the same kind)."""
    rng = np.random.RandomState(seed)
    k = _co_ids(rng, r, lk, kind)
    q = _co_ids(rng, r, lq, kind)
    pairs = [(q, k)] + ([(k, k)] if lq == lk else [])
    for qa, ka in pairs:
        qd, kd = _on(dev, qa, ka)
        before = ops.cooccurrence_counts.launches
        out = ops.cooccurrence_counts(qd, kd)
        assert ops.cooccurrence_counts.launches == before + 1
        ref = ops.cooccurrence_counts_plain(qd, kd)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32 and out.shape == (r, lq)
        np.testing.assert_array_equal(out.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.parametrize("seed,r,lq,lk,ids", CO_CASES)
def test_cooccurrence_kernel_matches_plain(dev, seed, r, lq, lk, ids):
    rng = np.random.RandomState(seed)
    q = rng.randint(0, ids, size=(r, lq)).astype(np.int32)
    k = rng.randint(0, ids, size=(r, lk)).astype(np.int32)
    qd, kd = _on(dev, q, k)
    before = ops.cooccurrence_counts.launches
    out = ops.cooccurrence_counts(qd, kd)
    assert ops.cooccurrence_counts.launches == before + 1
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (r, lq)
    ref = ops.cooccurrence_counts_plain(qd, kd)
    np.testing.assert_array_equal(out.cpu().numpy(), ref.cpu().numpy())


_COSINE_PROBE = r"""
#include "cos_reduced.cuh"
// y[i] = the kernel's cosine of x[i]: per element by the path its size
// allows (mode 0), or four arguments a thread through the warp-wide
// choice of cos_reduced<4> (mode 1; n a multiple of 4 * 32)
extern "C" __global__ void cosine(const float* x, float* y, int n, int mode) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (mode == 0) {
    if (i >= n) return;
    const float v = x[i];
    y[i] = fabsf(v) < dyglib::kSmallLimit   ? dyglib::cos_small(v)
           : fabsf(v) < dyglib::kReducedLimit ? dyglib::cos_large(v)
                                              : cosf(v);
    return;
  }
  if (4 * (i - threadIdx.x % 32) >= n) return;  // whole warps only
  dyglib::cos_reduced<4>(x + 4 * i, y + 4 * i);
}
extern "C" int run(const float* x, float* y, int n, int mode) {
  const int threads = mode == 1 ? n / 4 : n;
  cosine<<<(threads + 255) / 256, 256>>>(x, y, n, mode);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def test_reduced_cosine_is_torch_cos_bit_for_bit(dev, tmp_path):
    """csrc/cos_reduced.cuh against torch.cos on the card (the library's
    cosf, the plain version's cosine): equal in every bit, on each path
    and through the warp-wide choice, for |x| from 0 to 1e9 (both sides
    of cosf's fast range at 105615), and at inf and nan."""
    import ctypes
    import subprocess

    from dyglib_tpu_torch.ops import _build

    src, lib_path = tmp_path / "cosine.cu", tmp_path / "libcosine.so"
    src.write_text(_COSINE_PROBE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
                    str(lib_path), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    gen = torch.Generator(device=dev).manual_seed(5)
    parts = [torch.empty(1 << 20, device=dev).uniform_(lo, hi, generator=gen)
             for lo, hi in ((0, 1), (1, 1e3), (1e3, 105615), (105000, 106000), (105615, 1e6),
                            (1e6, 1e9))]
    x = torch.cat(parts + [-p for p in parts])
    x[:4] = torch.tensor([float("inf"), float("-inf"), float("nan"), 105615.0])
    want = torch.cos(x)
    for mode in (0, 1):
        y = torch.empty_like(x)
        assert lib.run(x.data_ptr(), y.data_ptr(), x.numel(), mode) == 0
        assert torch.equal(y[4:], want[4:])
        assert torch.isnan(y[:3]).all() and y[3] == want[3]


_SINE_PROBE = r"""
#include "cos_reduced.cuh"
// c[i], s[i] = cos(x[i]), -sin(x[i]) as the backward kernels take them:
// per element by the path its size allows (mode 0; mode 2: each polynomial
// evaluated once, sincos_quadrants, as the bf16 backward does), or four
// arguments a thread through the warp-wide choice of sincos_reduced<4>
// (mode 1; n a multiple of 4 * 32)
extern "C" __global__ void sine(const float* x, float* c, float* s, int n, int mode) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (mode != 1) {
    if (i >= n) return;
    const float v = x[i];
    if (mode == 2 && fabsf(v) < dyglib::kReducedLimit) {
      float r;
      int q;
      dyglib::reduce_small(v, r, q);
      if (!(fabsf(v) < dyglib::kSmallLimit)) dyglib::reduce_large(v, r, q);
      dyglib::sincos_quadrants(r, q, c[i], s[i]);
    } else if (fabsf(v) < dyglib::kSmallLimit) {
      dyglib::sincos_small(v, c[i], s[i]);
    } else if (fabsf(v) < dyglib::kReducedLimit) {
      dyglib::sincos_large(v, c[i], s[i]);
    } else {
      float sv;
      sincosf(v, &sv, c + i);
      s[i] = -sv;
    }
    return;
  }
  if (4 * (i - threadIdx.x % 32) >= n) return;  // whole warps only
  dyglib::sincos_reduced<4>(x + 4 * i, c + 4 * i, s + 4 * i);
}
extern "C" int run(const float* x, float* c, float* s, int n, int mode) {
  const int threads = mode == 1 ? n / 4 : n;
  sine<<<(threads + 255) / 256, 256>>>(x, c, s, n, mode);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def test_reduced_sine_is_torch_sin_bit_for_bit(dev, tmp_path):
    """csrc/cos_reduced.cuh's sincos against torch.sin and torch.cos on the
    card (the library's sinf and cosf, the plain backward's): -(-sin) and
    cos equal in every bit, on each path and through the warp-wide choice,
    for |x| from 0 to 1e9 (both sides of the fast range at 105615) and
    past 2^40, and nan at inf and nan; also the paths that evaluate each
    polynomial once for both (the bf16 backward's). The sine is the
    cosine's kernel one quadrant lower, as the library builds sinf."""
    import ctypes
    import subprocess

    from dyglib_tpu_torch.ops import _build

    src, lib_path = tmp_path / "sine.cu", tmp_path / "libsine.so"
    src.write_text(_SINE_PROBE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
                    str(lib_path), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int]
    gen = torch.Generator(device=dev).manual_seed(6)
    parts = [torch.empty(1 << 20, device=dev).uniform_(lo, hi, generator=gen)
             for lo, hi in ((0, 1), (1, 1e3), (1e3, 105615), (105000, 106000), (105615, 1e6),
                            (1e6, 1e9), (1e12, 1e13))]
    x = torch.cat(parts + [-p for p in parts])
    x[:4] = torch.tensor([float("inf"), float("-inf"), float("nan"), 105615.0])
    want_sin, want_cos = torch.sin(x), torch.cos(x)
    for mode in (0, 1, 2):
        c, ms = torch.empty_like(x), torch.empty_like(x)
        assert lib.run(x.data_ptr(), c.data_ptr(), ms.data_ptr(), x.numel(), mode) == 0
        assert torch.equal(-ms[4:], want_sin[4:])
        assert torch.equal(c[4:], want_cos[4:])
        assert torch.isnan(ms[:3]).all() and torch.isnan(c[:3]).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Wrong dtype, non-contiguous or mismatched operands raise before any
    launch; nothing falls back to the plain version."""
    q = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="dtype"):
        ops.cooccurrence_counts(q.long(), q)
    with pytest.raises(ValueError, match="contiguous"):
        ops.cooccurrence_counts(q.t(), q.t())
    x = torch.zeros((2, 8, 5), device=dev)
    with pytest.raises(ValueError, match="shape"):
        ops.patch_projection(x, torch.zeros((11, 3), device=dev), torch.zeros(3, device=dev), 2)
    with pytest.raises(ValueError, match="multiple"):
        ops.patch_projection(x, torch.zeros((15, 3), device=dev), torch.zeros(3, device=dev), 3)
    strided_w = torch.zeros((20, 3), device=dev)[::2]  # neither layout the kernel reads
    with pytest.raises(ValueError, match="transpose"):
        ops.patch_projection(x, strided_w, torch.zeros(3, device=dev), 2)
    dt = torch.zeros((2, 8), device=dev)
    valid = torch.ones((2, 8), dtype=torch.bool, device=dev)
    tw, bias = torch.zeros(4, device=dev), torch.zeros(3, device=dev)
    w = torch.zeros((8, 3), device=dev)
    with pytest.raises(ValueError, match="on cpu"):
        ops.time_channel_projection(dt, valid, tw, torch.zeros(4), w, bias, 2)
    with pytest.raises(ValueError, match="dtype"):  # valid must be bool on the card
        ops.time_channel_projection(dt, dt, tw, tw, w, bias, 2)
    assert ops.launch_counts() == before


# ---- backward kernels and the window fetch
#
# Gradient tolerance: each entry of dW, dbias, dtw and dtb is a sum over
# rows (and patch slots) that the kernel and the plain version take in
# different orders; the difference is held to 3e-5 of the sum of the
# absolute values of its terms (the same sums of |terms|, computed by the
# plain formulas on |operands|). dtw's terms carry dt up to 1e7, so a fixed
# atol would be meaningless there. The fetch must be bitwise equal.
GRAD_RTOL = 3e-5


def _abs_terms_time(dt, valid, tw, tb, w, dout, patch, rounded=False):
    """Per-entry sums of |terms| of the four time-channel gradients
    (``rounded``: of the bf16 variant's products, Phi, dout and W rounded to
    bf16; dbias's terms stay the f32 dout's)."""
    theta = dt[..., None] * tw + tb
    mask = valid[..., None]
    phi = torch.where(mask, torch.cos(theta).abs(), 0.0).reshape(-1, w.shape[0])
    g = dout.reshape(-1, dout.shape[-1]).abs()
    g_sum = g.sum(0)
    if rounded:
        phi, g, w = (t.to(torch.bfloat16).float() for t in (phi, g, w))
    common = torch.where(mask, (g @ w.abs().t()).reshape(theta.shape) * torch.sin(theta).abs(), 0.0)
    return ((common * dt[..., None].abs()).sum((0, 1)), common.sum((0, 1)), phi.t() @ g, g_sum)


def _assert_grads_close(got, want, terms, names):
    for g, w, t, name in zip(got, want, terms, names):
        assert g.shape == w.shape, name
        excess = ((g - w).abs() - GRAD_RTOL * t).max().item()
        assert excess <= 1e-30, f"{name}: |kernel - plain| exceeds {GRAD_RTOL} x sum|terms|"


# (seed, M, L, patch, Dt, ced, dt scale)
TIME_BWD_CASES = [
    (0, 7, 12, 4, 6, 9, 1e2),  # ragged everything
    (1, 70, 33, 1, 100, 50, 1e6),  # patch 1, two row tiles (the second ragged)
    (2, 9, 64, 8, 100, 130, 1e7),  # ced 130: three column tiles
    (3, 600, 64, 64, 100, 50, 1e6),  # patch 64, several row chunks
]


@pytest.mark.parametrize("layout", ["rows", "linear"])
@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced,scale", TIME_BWD_CASES)
def test_time_channel_backward_kernel_matches_plain(
    dev, seed, m, l, patch, dt_dim, ced, scale, layout
):
    rng = np.random.RandomState(seed)
    dt = np.floor(rng.rand(m, l) * scale).astype(np.float32)
    valid = rng.rand(m, l) > 0.3
    tw = (1.0 / 10 ** np.linspace(0, 9, dt_dim)).astype(np.float32)
    tb = (rng.randn(dt_dim) * 0.1).astype(np.float32)
    w = (rng.randn(patch * dt_dim, ced) * (patch * dt_dim) ** -0.5).astype(np.float32)
    dout = rng.randn(m, l // patch, ced).astype(np.float32)
    dt, valid, tw, tb, w, dout = _on(dev, dt, valid, tw, tb, w, dout)
    args = (dt, valid, tw, tb, _layout(w, layout), dout, patch)
    before = ops.time_channel_backward.launches
    got = ops.time_channel_backward(*args)
    again = ops.time_channel_backward(*args)
    assert ops.time_channel_backward.launches == before + 2
    want = ops.time_channel_backward_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, again):  # the two-pass reduction is deterministic
        assert torch.equal(a, b)
    _assert_grads_close(got, want, _abs_terms_time(*args), ("dtw", "dtb", "dW", "dbias"))


# the backward's edges (csrc/time_channel.cu): every position masked (dbias
# alone), rows that fill no 32-row stage or 128-entry tile evenly, theta
# past cosf's fast range (dt 1e6) and past 2^40 (dt 1e13: the library's
# sincosf), Dt 8 and 128 (no padding) and 1, 6, 101 (padded), ced 1, 7
# (4-byte dout copies), 57 and 130 (column tiles), no rows and one row.
# (seed, M, L, patch, Dt, ced, dt scale, tb shift, masked rows)
TIME_BWD_EDGE_CASES = [
    (30, 12, 2048, 64, 100, 50, 1e6, 0.0, 12),  # every position masked
    (31, 7, 2048, 64, 100, 50, 1e6, 0.0, 3),  # 224 rows, some masked
    (32, 33, 32, 1, 100, 50, 1e6, 0.0, 0),  # 1056 rows, patch 1
    (33, 5, 256, 8, 100, 50, 1e13, 0.0, 0),  # theta past 2^40
    (34, 9, 64, 8, 8, 7, 1e6, 0.0, 0),  # Dt 8, ced 7
    (35, 6, 64, 2, 128, 57, 1e6, -3.0, 0),  # Dt 128, two column tiles, tb < 0
    (36, 40, 32, 1, 1, 1, 1e6, 0.0, 0),  # Dt 1, ced 1
    (37, 11, 64, 8, 101, 130, 1e8, 0.0, 2),  # Dt 101, three column tiles
    (38, 0, 64, 8, 100, 50, 1e6, 0.0, 0),  # no rows: zero gradients
    (39, 1, 2048, 64, 100, 50, 1e6, 0.0, 0),  # one row at K = 6400
    (40, 3, 24, 4, 6, 9, 1e2, 0.0, 0),  # ragged everything, Dt 6
]


@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced,scale,tb_shift,masked",
                         TIME_BWD_EDGE_CASES)
def test_time_channel_backward_kernel_edges(dev, seed, m, l, patch, dt_dim, ced, scale,
                                            tb_shift, masked):
    """Within GRAD_RTOL of the plain backward's sums of |terms|, a second
    launch bitwise equal to the first."""
    dt, valid, tw, tb, w, _ = _time_inputs(dev, seed, m, l, patch, dt_dim, ced, scale,
                                           tb_shift, masked)
    dout = torch.from_numpy(
        np.random.RandomState(seed + 1).randn(m, l // patch, ced).astype(np.float32)).to(dev)
    args = (dt, valid, tw, tb, _layout(w, "linear"), dout, patch)
    before = ops.time_channel_backward.launches
    got = ops.time_channel_backward(*args)
    again = ops.time_channel_backward(*args)
    assert ops.time_channel_backward.launches == before + 2
    want = ops.time_channel_backward_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
        assert torch.isfinite(a).all()
    _assert_grads_close(got, want, _abs_terms_time(*args), ("dtw", "dtb", "dW", "dbias"))
    if masked >= m:
        assert not got[0].any() and not got[1].any() and not got[2].any()


# the bf16 backward's edges (csrc/time_channel_bf16_bwd.cuh): 1, 63, 65
# and 129 rows (partial 64-row stages), ced 56, 57 and 65 (a second 64-column
# tile at 65), Dt 6 and 1 (entries padded to 16) and 101 (unpadded), patch
# 1, 4 and 64, every position masked, theta past 105615 (the double
# reduction) and past 2^40 (sincosf). (seed, M, L, patch, Dt, ced, dt
# scale, masked rows)
BF16_TIME_BWD_EDGES = [
    (50, 1, 1, 1, 100, 50, 1e6, 0),  # one row, patch 1
    (51, 63, 4, 4, 100, 56, 1e6, 0),  # 63 rows, ced 56
    (52, 65, 64, 64, 100, 57, 1e6, 0),  # 65 rows of K = 6400, ced 57
    (53, 129, 4, 4, 6, 65, 1e6, 0),  # 129 rows, Dt 6, two column tiles
    (54, 13, 64, 64, 101, 9, 1e8, 0),  # Dt 101 unpadded, theta past 105615
    (55, 30, 16, 4, 1, 1, 1e6, 0),  # Dt 1, ced 1, patch 4
    (56, 10, 128, 64, 100, 50, 1e6, 10),  # every position masked
    (57, 9, 256, 8, 100, 50, 1e13, 0),  # theta past 2^40
]


@pytest.mark.parametrize("layout", ["rows", "linear"])
@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced,scale,masked",
                         BF16_TIME_CASES + BF16_TIME_BWD_EDGES)
def test_bf16_time_backward_kernel_matches_plain(dev, seed, m, l, patch, dt_dim, ced, scale,
                                                 masked, layout):
    """The bf16 time-channel backward on wgmma within GRAD_RTOL of each
    gradient's sum|terms| (its bf16 operands') from its plain bf16
    version, a second launch bitwise equal, zero dW, dtw and dtb where
    every position is masked."""
    dt, valid, tw, tb, w, _ = _time_inputs(dev, seed, m, l, patch, dt_dim, ced, scale,
                                           masked_rows=masked)
    dout = torch.from_numpy(
        np.random.RandomState(seed + 1).randn(m, l // patch, ced).astype(np.float32)).to(dev)
    bf16 = torch.bfloat16
    args = (dt, valid, tw, tb, _layout(w, layout), dout, patch)
    ops.reset_launch_counts()
    got = ops.time_channel_backward(*args, compute_dtype=bf16)
    again = ops.time_channel_backward(*args, compute_dtype=bf16)
    assert {c: v for c, v in ops.launch_counts().items() if v} == {"time_channel_bf16_bwd": 2}
    want = ops.time_channel_backward_plain(*args, compute_dtype=bf16)
    terms = _abs_terms_time(*args, rounded=True)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
        assert torch.isfinite(a).all()
    _assert_grads_close(got, want, terms, ("dtw", "dtb", "dW", "dbias"))
    if masked >= m:
        assert not got[0].any() and not got[1].any() and not got[2].any()


# (seed, M, Lp, D, patch, ced, input scale, offset), as PATCH_CASES
PATCH_BWD_CASES = [
    (0, 5, 12, 7, 3, 9, 1.0, 0),  # K = 21, ragged
    (1, 70, 32, 172, 1, 50, 1.0, 0),  # patch 1
    (2, 11, 64, 17, 64, 100, 1.0, 0),  # K = 1088, two column tiles
    (3, 600, 128, 172, 64, 50, 1.0, 0),  # the CanParl K = 11008, several row chunks
    (4, 4, 8, 3, 1, 1, 1.0, 0),  # ced 1
    (5, 33, 16, 7, 2, 7, 1.0, 0),  # ced 7
    (6, 40, 16, 43, 4, 56, 1.0, 0),  # ced 56
    (7, 130, 4, 172, 1, 57, 1.0, 0),  # ced 57
    (8, 3, 128, 17, 64, 130, 1.0, 0),  # ced 130
    (9, 9, 15, 7, 3, 50, 1.0, 1),  # K = 21 from a 4-byte-aligned x
    (10, 0, 8, 5, 2, 50, 1.0, 0),  # no rows: zero gradients
    (11, 1, 64, 172, 64, 50, 1.0, 0),  # one row
    (12, 200, 64, 172, 64, 50, 1e4, 0),  # inputs ~1e4
]


@pytest.mark.parametrize("seed,m,lp,d,patch,ced,scale,offset", PATCH_BWD_CASES)
def test_patch_projection_backward_kernel_matches_plain(
    dev, seed, m, lp, d, patch, ced, scale, offset
):
    rng = np.random.RandomState(seed)
    big = _patch_input(rng, m, lp, d, offset, scale)
    dout = rng.randn(m, lp // patch, ced).astype(np.float32)
    big, dout = _on(dev, big, dout)
    x = big[offset:]
    before = ops.patch_projection_backward.launches
    got = ops.patch_projection_backward(x, dout, patch)
    again = ops.patch_projection_backward(x, dout, patch)
    assert ops.patch_projection_backward.launches == before + 2
    want = ops.patch_projection_backward_plain(x, dout, patch)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    g = dout.reshape(-1, ced).abs()
    terms = (x.reshape(g.shape[0], patch * d).abs().t() @ g, g.sum(0))
    _assert_grads_close(got, want, terms, ("dW", "dbias"))


# (seed, M, seq_len, dn, de): 16-byte path (widths multiples of 4) and the
# scalar path; seq_len not a multiple of the 16-position tile
FETCH_CASES = [(0, 37, 64, 172, 172), (1, 5, 33, 10, 7), (2, 600, 2048, 172, 172)]


@pytest.mark.parametrize("seed,m,seq_len,dn,de", FETCH_CASES)
def test_window_fetch_kernel_equals_plain(dev, seed, m, seq_len, dn, de):
    rng = np.random.RandomState(seed)
    pad, entries = seq_len, 3000
    table = rng.randn(2 * pad + entries + 64, dn + de).astype(np.float32)
    table[:pad] = 0.0  # the guard rows, row 0 among them
    counts = rng.randint(0, seq_len, m).astype(np.int32)
    counts[:2] = (0, seq_len - 1)  # an empty and a full window
    starts = (pad + rng.randint(0, entries - seq_len, m)).astype(np.int32)
    tgts = (2 * pad + entries + rng.randint(0, 64, m)).astype(np.int32)
    args = (*_on(dev, table, tgts, starts, counts), seq_len, dn)
    before = ops.fetch_sequence_features.launches
    node, edge = ops.fetch_sequence_features(*args)
    assert ops.fetch_sequence_features.launches == before + 1
    ref_node, ref_edge = ops.fetch_sequence_features_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(node, ref_node) and torch.equal(edge, ref_edge)
    assert not node[0, 1:].any() and torch.equal(node[1, seq_len - 1], args[0][int(starts[1]) + seq_len - 2, :dn])


def _tgat_case(dev, config, sample_strategy="recent"):
    """TGAT at small widths on the card, in one of its kernel configurations:
    (tgat, tables, csr, ids, ts) with ids and ts the first val edges'
    endpoints."""
    from dyglib_tpu_torch.data import synthetic_link_prediction_data
    from dyglib_tpu_torch.graph import build_temporal_csr
    from dyglib_tpu_torch.models import TGAT, FeatureTables

    kw = {
        "default": {}, "entry_table": {}, "window": dict(wants_entry_features=True),
        "phi_fusion": dict(use_gathered_attention=False, use_phi_fusion=True),
    }[config]
    data = synthetic_link_prediction_data(num_src=60, num_dst=30, num_edges=1500, seed=3)
    feats = (data.node_raw_features[:, :12].copy(), data.edge_raw_features[:, :12].copy())
    table = dict(feat_entry_of=feats) if config in ("entry_table", "window") else {}
    csr = build_temporal_csr(data.full, num_nodes=data.num_nodes, device=dev, **table)
    tables = FeatureTables(*(torch.from_numpy(f).to(dev) for f in feats))
    tgat = TGAT(num_neighbors=5, time_feat_dim=10, sample_strategy=sample_strategy, **kw)
    ids = torch.from_numpy(np.concatenate([data.val.src[:20], data.val.dst[:20]]).astype(np.int32))
    ts = torch.from_numpy(data.val.ts[:20].astype(np.int32)).repeat(2)
    return tgat, tables, csr, ids.to(dev), ts.to(dev)


# the kernels each TGAT configuration launches in one forward and backward
TGAT_LAUNCHES = {
    "default": {"gathered_attention": 2, "temporal_attention": 1},
    "entry_table": {"gathered_attention": 2, "temporal_attention": 1},
    "window": {"window_attention": 2, "temporal_attention": 1},
    "phi_fusion": {"phi_projection": 6},
}


@pytest.mark.parametrize("model", ["dygformer", *(f"tgat_{c}" for c in TGAT_LAUNCHES)])
def test_every_parameter_gets_a_gradient_through_the_kernels(dev, model):
    """One backward on the card through the kernels: every parameter of the
    net (DyGFormerNet, or TGATNet in each kernel configuration) and of
    MergeLayer has a finite gradient, equal to the plain path's within the
    gradient tolerance of the layers above; the kernel path launches every
    forward kernel's backward kernel, the plain path none."""
    from dyglib_tpu_torch.models import DyGFormer, DyGFormerInputs, FeatureTables
    from dyglib_tpu_torch.nn import MergeLayer

    rng = np.random.RandomState(0)
    if model == "dygformer":
        m, lp, n_nodes, n_edges, feat = 3 * 8, 16, 50, 200, 12
        seq_ids = rng.randint(1, n_nodes, (m, lp)).astype(np.int32)
        seq_ids[:, 10:] = 0
        inputs = DyGFormerInputs(
            *_on(dev, seq_ids,
                 np.where(seq_ids > 0, rng.randint(1, n_edges, (m, lp)), 0).astype(np.int32),
                 rng.randint(0, 1000, (m, lp)).astype(np.int32), np.full(m, 2000, np.int32))
        )
        node = rng.randn(n_nodes, feat).astype(np.float32)
        edge = rng.randn(n_edges, feat).astype(np.float32)
        node[0] = edge[0] = 0.0
        tables = FeatureTables(*_on(dev, node, edge))
        expected = {"time_channel_bwd", "patch_projection_bwd"}
    else:
        config = model[len("tgat_"):]
        tgat, tables, csr, ids, ts = _tgat_case(dev, config)
        inputs = tgat.sample(csr, ids, ts)
        feat = 12
        expected = {f"{k}_bwd": v for k, v in TGAT_LAUNCHES[config].items()}
    grads = {}
    for use_kernels in (True, False):
        gen = torch.Generator().manual_seed(0)
        if model == "dygformer":
            net = DyGFormer(max_input_sequence_length=lp, patch_size=4, channel_embedding_dim=8,
                            time_feat_dim=8, dropout=0.0,
                            use_kernels=use_kernels).build(feat, feat, gen)
            forward = lambda: net(tables, inputs, triple=True)
        else:
            net = tgat.build(feat, feat, gen)
            net.use_kernels = use_kernels
            forward = lambda: net(tables, inputs)
        head = MergeLayer(2 * feat, feat, 1, gen)
        net, head = net.to(dev).eval(), head.to(dev)
        before = ops.launch_counts()
        emb = forward()
        s, d, ns, nd = emb.split(emb.shape[0] // 4) if model == "dygformer" else (
            *emb.split(emb.shape[0] // 2), *emb.flip(0).split(emb.shape[0] // 2))
        (head(s, d).sum() - head(ns, nd).sum()).backward()
        after = ops.launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        if not use_kernels:
            assert not launched
        elif model == "dygformer":
            assert expected <= set(launched)
        else:
            assert {k: v for k, v in launched.items() if k.endswith("_bwd")} == expected
        grads[use_kernels] = {
            k: p.grad for mod in (net, head) for k, p in mod.named_parameters(prefix=mod._get_name())
        }
    for k, g in grads[True].items():
        assert g is not None and torch.isfinite(g).all(), k
        ref = grads[False][k]
        torch.testing.assert_close(g, ref, atol=1e-4 * (1 + float(ref.abs().max())), rtol=0, msg=k)


# ---- TGAT's attention kernels, forward and backward
#
# Tolerance: ATOL for the forwards. An output is a softmax-weighted sum of
# val rows, each a sum of Dkv <= 444 products of O(1) values; the kernel
# reassociates it (logits against qk = Wk_h q3_h, out_h = Av Wv_h) and takes
# the sums in another order than cuBLAS. The all-padded row (row 0) attends
# uniformly. A second launch is bitwise equal to the first. The backwards:
# GRAD_RTOL of each entry's sum of |terms| (the plain backward's
# ``abs_terms``), and a second run bitwise equal.

# (seed, M, K, dn, de, Dt, Dq, heads)
ATTN_CASES = [
    (0, 2, 20, 172, 172, 100, 272, 2),  # fewer queries than one 32-row product tile
    # published widths (16-byte staging); M a multiple of no product tile's rows (128, 64, 32)
    (1, 700, 20, 172, 172, 100, 272, 2),
    (2, 37, 7, 12, 5, 9, 30, 3),  # ragged widths: rows staged a float at a time
    (3, 5, 64, 8, 8, 8, 16, 4),  # K = 64, four heads
    (4, 70, 1, 12, 12, 10, 22, 2),  # K = 1
    (5, 9, 96, 12, 12, 8, 22, 2),  # K = 96: more kv rows a query than one 64-row tile
    (6, 600, 10, 172, 172, 100, 272, 2),  # TGN's and DyRep's shape: the B = 200 triple, K = 10
    (7, 12_000, 20, 172, 172, 100, 272, 2),  # TGAT's layer 1, hop 1: 128-row product blocks
    # Dkv 443: the products' rows (a row stride of heads x 443) take 4-byte copies
    (8, 333, 20, 171, 172, 100, 272, 2),
]


def _attention_case(dev, seed, m, k, dn, de, dt_dim, dq, heads, layout="linear"):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mask = (rng.rand(m, k) > 0.3).astype(np.float32)
    mask[0] = 0.0
    t_rows = 3 * k + 50
    kv = dn + de + dt_dim
    arrays = dict(
        q3=f(m, dq), nbr=f(m, k, dn), edge=f(m, k, de), phi=f(m, k, dt_dim),
        dt=np.floor(rng.rand(m, k) * 2.6e6).astype(np.float32), mask=mask,
        keep=((rng.rand(m, heads, k) > 0.1) / 0.9).astype(np.float32),
        tw=(1.0 / 10 ** np.linspace(0, 9, dt_dim)).astype(np.float32), tb=f(dt_dim) * 0.1,
        table=f(t_rows, dn + de), starts=rng.randint(0, t_rows - k + 1, m).astype(np.int32),
        wk=f(kv, dq) * kv**-0.5, wv=f(kv, dq) * kv**-0.5,
    )
    t = {name: torch.from_numpy(a).to(dev) for name, a in arrays.items()}
    t["wk"], t["wv"] = _layout(t["wk"], layout), _layout(t["wv"], layout)
    return t


def _launched_once(fn, *args):
    before = fn.launches
    out = fn(*args)
    assert fn.launches == before + 1
    return out


def _forward_twice(fn, *args):
    """The kernel's outputs, launched once each time, twice: bitwise equal."""
    out = _launched_once(fn, *args)
    again = _launched_once(fn, *args)
    torch.cuda.synchronize()
    for a, b in zip(*((out, again) if isinstance(out, tuple) else ((out,), (again,)))):
        assert torch.equal(a, b), "two launches differ"
    return out


@pytest.mark.parametrize("layout", ["rows", "linear"])
@pytest.mark.parametrize("seed,m,k,dn,de,dt_dim,dq,heads", ATTN_CASES)
def test_temporal_attention_kernel_matches_plain(dev, seed, m, k, dn, de, dt_dim, dq, heads,
                                                 layout):
    t = _attention_case(dev, seed, m, k, dn, de, dt_dim, dq, heads, layout)
    args = (t["q3"], t["nbr"], t["edge"], t["phi"], t["mask"], t["keep"], t["wk"], t["wv"], heads)
    out, scores = _forward_twice(ops.temporal_attention, *args)
    ref_out, ref_scores = ops.temporal_attention_plain(*args)
    torch.cuda.synchronize()
    assert out.shape == (m, dq) and scores.shape == (m, heads, k)
    torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=0)
    torch.testing.assert_close(scores, ref_scores, atol=ATOL, rtol=0)
    torch.testing.assert_close(scores[0], t["keep"][0] / k, atol=1e-6, rtol=0)


@pytest.mark.parametrize("layout", ["rows", "linear"])
@pytest.mark.parametrize("seed,m,k,dn,de,dt_dim,dq,heads", ATTN_CASES)
def test_gathered_attention_kernel_matches_plain(dev, seed, m, k, dn, de, dt_dim, dq, heads,
                                                 layout):
    t = _attention_case(dev, seed, m, k, dn, de, dt_dim, dq, heads, layout)
    args = (t["q3"], t["nbr"].reshape(m * k, dn), t["edge"].reshape(m * k, de), t["dt"],
            t["mask"], t["keep"], (t["tw"], t["tb"]), (t["wk"], t["wv"]), heads)
    out = _forward_twice(ops.gathered_attention, *args)
    ref = ops.gathered_attention_plain(*args)
    torch.cuda.synchronize()
    assert out.shape == (m, dq) and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("layout", ["rows", "linear"])
@pytest.mark.parametrize("seed,m,k,dn,de,dt_dim,dq,heads", ATTN_CASES)
def test_window_attention_kernel_matches_plain(dev, seed, m, k, dn, de, dt_dim, dq, heads,
                                               layout):
    t = _attention_case(dev, seed, m, k, dn, de, dt_dim, dq, heads, layout)
    args = (t["q3"], t["starts"], t["dt"], t["mask"], t["keep"], t["table"], t["tw"], t["tb"],
            (t["wk"], t["wv"]), heads)
    out = _forward_twice(ops.window_attention, *args)
    ref = ops.window_attention_plain(*args)
    torch.cuda.synchronize()
    assert out.shape == (m, dq) and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


# (seed, R, Dt, Dq, dt scale): ragged rows and columns (Dt 101 padded to
# 104, Dq 137 three column tiles); hop 0's and hop 1's R at the published
# widths (the forward's plan splits R = 12,000 into two column groups);
# deltas up to 1e6 and 2.6e6 (|theta| past 105615: the double reduction)
PHI_CASES = [(0, 7, 10, 16, 2.6e6), (1, 130, 9, 70, 2.6e6), (3, 1000, 101, 137, 1e6),
             (4, 12_000, 100, 272, 1e6), (2, 240_000, 100, 272, 2.6e6)]


@pytest.mark.parametrize("layout", ["rows", "linear_slice"])
@pytest.mark.parametrize("seed,r,dt_dim,dq,scale", PHI_CASES)
def test_phi_projection_kernel_matches_plain(dev, seed, r, dt_dim, dq, scale, layout):
    rng = np.random.RandomState(seed)
    dt = torch.from_numpy(np.floor(rng.rand(r) * scale).astype(np.float32)).to(dev)
    tw = torch.from_numpy((1.0 / 10 ** np.linspace(0, 9, dt_dim)).astype(np.float32)).to(dev)
    tb = torch.from_numpy((rng.randn(dt_dim) * 0.1).astype(np.float32)).to(dev)
    if layout == "rows":
        w = torch.from_numpy((rng.randn(dt_dim, dq) * dt_dim**-0.5).astype(np.float32)).to(dev)
    else:  # the Phi rows of nn.Linear's (dq, 24 + Dt) weight, transposed: a strided view
        weight = torch.from_numpy(rng.randn(dq, 24 + dt_dim).astype(np.float32)).to(dev)
        w = weight.t()[24:]
        assert not w.is_contiguous() and not w.t().is_contiguous()
    out = _forward_twice(ops.phi_projection, dt, tw, tb, w)
    ref = ops.phi_projection_plain(dt, tw, tb, w)
    torch.cuda.synchronize()
    assert out.shape == (r, dq)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


def _backward_checked(kernel_bwd, plain_bwd, args, names):
    """The backward kernel launched twice (bitwise equal runs) against its
    plain version within GRAD_RTOL of the sums of |terms|."""
    before = kernel_bwd.launches
    got = kernel_bwd(*args)
    again = kernel_bwd(*args)
    assert kernel_bwd.launches == before + 2
    want = plain_bwd(*args)
    terms = plain_bwd(*args, abs_terms=True)
    torch.cuda.synchronize()
    for a, b, name in zip(got, again, names):
        assert torch.equal(a, b), f"{name}: two runs differ"
        assert torch.isfinite(a).all(), name
    _assert_grads_close(got, want, terms, names)


@pytest.mark.parametrize("seed,m,k,dn,de,dt_dim,dq,heads", ATTN_CASES)
def test_temporal_attention_backward_kernel_matches_plain(dev, seed, m, k, dn, de, dt_dim, dq,
                                                          heads):
    t = _attention_case(dev, seed, m, k, dn, de, dt_dim, dq, heads)
    rng = np.random.RandomState(seed + 50)
    dout = torch.from_numpy(rng.randn(m, dq).astype(np.float32)).to(dev)
    # the scores' cotangent: none (zeros) in one case, as JAX's is
    dscores = None if seed == 2 else torch.from_numpy(
        rng.randn(m, heads, k).astype(np.float32)).to(dev)
    args = (t["q3"], t["nbr"], t["edge"], t["phi"], t["mask"], t["keep"], t["wk"], t["wv"],
            dout, dscores, heads)
    _backward_checked(ops.temporal_attention_backward, ops.temporal_attention_backward_plain,
                      args, ("dq3", "dnbr", "dedge", "dphi", "dwk", "dwv"))


@pytest.mark.parametrize("layout", ["rows", "linear"])
@pytest.mark.parametrize("seed,m,k,dn,de,dt_dim,dq,heads", ATTN_CASES)
def test_gathered_attention_backward_kernel_matches_plain(dev, seed, m, k, dn, de, dt_dim, dq,
                                                          heads, layout):
    t = _attention_case(dev, seed, m, k, dn, de, dt_dim, dq, heads, layout)
    dout = torch.from_numpy(np.random.RandomState(seed + 50).randn(m, dq).astype(np.float32))
    args = (t["q3"], t["nbr"].reshape(m * k, dn), t["edge"].reshape(m * k, de), t["dt"],
            t["mask"], t["keep"], (t["tw"], t["tb"]), (t["wk"], t["wv"]), dout.to(dev), heads)
    _backward_checked(ops.gathered_attention_backward, ops.gathered_attention_backward_plain,
                      args, ("dq3", "dtw", "dtb", "dwk", "dwv"))


@pytest.mark.parametrize("seed,m,k,dn,de,dt_dim,dq,heads", ATTN_CASES)
def test_window_attention_backward_kernel_matches_plain(dev, seed, m, k, dn, de, dt_dim, dq,
                                                        heads):
    t = _attention_case(dev, seed, m, k, dn, de, dt_dim, dq, heads)
    dout = torch.from_numpy(np.random.RandomState(seed + 50).randn(m, dq).astype(np.float32))
    args = (t["q3"], t["starts"], t["dt"], t["mask"], t["keep"], t["table"], t["tw"], t["tb"],
            (t["wk"], t["wv"]), dout.to(dev), heads)
    _backward_checked(ops.window_attention_backward, ops.window_attention_backward_plain,
                      args, ("dq3", "dtw", "dtb", "dwk", "dwv"))


# the backward query kernel's edges (csrc/attention_bwd.cuh): K 1, 33 (a
# second pass of the softmax warp's lanes) and 96 at the published widths
# (the largest K whose rows and sines fit one block), every query masked, a
# mask of 0.5 on some rows (the window kernel scales its rows by the mask),
# one head and four. (seed, M, K, dn, de, Dt, Dq, heads, mask)
ATTN_BWD_EDGE_CASES = [
    (20, 40, 1, 172, 172, 100, 272, 2, "random"),
    (21, 30, 33, 172, 172, 100, 272, 2, "random"),
    (22, 12, 96, 172, 172, 100, 272, 2, "random"),
    (23, 25, 20, 172, 172, 100, 272, 2, "none"),
    (24, 50, 20, 172, 172, 100, 272, 1, "random"),
    (25, 50, 33, 172, 172, 100, 272, 4, "random"),
    (26, 30, 20, 172, 172, 100, 272, 2, "halves"),
]


@pytest.mark.parametrize("kernel", ["temporal", "gathered", "window"])
@pytest.mark.parametrize("seed,m,k,dn,de,dt_dim,dq,heads,mask", ATTN_BWD_EDGE_CASES)
def test_attention_backward_kernels_at_edges(dev, kernel, seed, m, k, dn, de, dt_dim, dq, heads,
                                             mask):
    t = _attention_case(dev, seed, m, k, dn, de, dt_dim, dq, heads)
    if mask == "none":
        t["mask"].zero_()
    elif mask == "halves":
        t["mask"][::2] *= 0.5
    dout = torch.from_numpy(np.random.RandomState(seed + 50).randn(m, dq).astype(np.float32))
    dout = dout.to(dev)
    grads = ("dq3", "dtw", "dtb", "dwk", "dwv")
    if kernel == "temporal":
        args = (t["q3"], t["nbr"], t["edge"], t["phi"], t["mask"], t["keep"], t["wk"], t["wv"],
                dout, None, heads)
        _backward_checked(ops.temporal_attention_backward, ops.temporal_attention_backward_plain,
                          args, ("dq3", "dnbr", "dedge", "dphi", "dwk", "dwv"))
    elif kernel == "gathered":
        args = (t["q3"], t["nbr"].reshape(m * k, dn), t["edge"].reshape(m * k, de), t["dt"],
                t["mask"], t["keep"], (t["tw"], t["tb"]), (t["wk"], t["wv"]), dout, heads)
        _backward_checked(ops.gathered_attention_backward,
                          ops.gathered_attention_backward_plain, args, grads)
    else:
        args = (t["q3"], t["starts"], t["dt"], t["mask"], t["keep"], t["table"], t["tw"],
                t["tb"], (t["wk"], t["wv"]), dout, heads)
        _backward_checked(ops.window_attention_backward, ops.window_attention_backward_plain,
                          args, grads)


@pytest.mark.parametrize("layout", ["rows", "linear_slice"])
@pytest.mark.parametrize("seed,r,dt_dim,dq,scale", PHI_CASES)
def test_phi_projection_backward_kernel_matches_plain(dev, seed, r, dt_dim, dq, scale, layout):
    rng = np.random.RandomState(seed)
    dt = torch.from_numpy(np.floor(rng.rand(r) * scale).astype(np.float32)).to(dev)
    tw = torch.from_numpy((1.0 / 10 ** np.linspace(0, 9, dt_dim)).astype(np.float32)).to(dev)
    tb = torch.from_numpy((rng.randn(dt_dim) * 0.1).astype(np.float32)).to(dev)
    if layout == "rows":
        w = torch.from_numpy((rng.randn(dt_dim, dq) * dt_dim**-0.5).astype(np.float32)).to(dev)
    else:
        weight = torch.from_numpy(rng.randn(dq, 24 + dt_dim).astype(np.float32)).to(dev)
        w = weight.t()[24:]
    dout = torch.from_numpy(rng.randn(r, dq).astype(np.float32)).to(dev)
    _backward_checked(ops.phi_projection_backward, ops.phi_projection_backward_plain,
                      (dt, tw, tb, w, dout), ("dtw", "dtb", "dw"))


def test_attention_wrappers_run_in_grad_mode_and_refuse_what_they_do_not_take(dev):
    """A CUDA call of any of the four wrappers with an input that requires
    grad returns an output with a grad_fn, and its backward launches the
    backward kernel once. Shapes, dtypes and devices the kernels do not
    take raise before any launch."""
    m, k, heads = 4, 5, 2
    t = _attention_case(dev, 9, m, k, 8, 8, 6, 14, heads)
    calls = {
        "temporal_attention": lambda w: ops.temporal_attention(
            t["q3"], t["nbr"], t["edge"], t["phi"], t["mask"], t["keep"], w, t["wv"], heads)[0],
        "gathered_attention": lambda w: ops.gathered_attention(
            t["q3"], t["nbr"].reshape(m * k, -1), t["edge"].reshape(m * k, -1), t["dt"],
            t["mask"], t["keep"], (t["tw"], t["tb"]), (w, t["wv"]), heads),
        "window_attention": lambda w: ops.window_attention(
            t["q3"], t["starts"], t["dt"], t["mask"], t["keep"], t["table"], t["tw"], t["tb"],
            (w, t["wv"]), heads),
        "phi_projection": lambda w: ops.phi_projection(t["dt"], t["tw"], t["tb"], w[-6:]),
    }
    for name, call in calls.items():
        wk = t["wk"].detach().clone().requires_grad_(True)
        before = ops.launch_counts()
        out = call(wk)
        assert out.grad_fn is not None, name
        out.square().sum().backward()
        after = ops.launch_counts()
        assert {k_: after[k_] - before[k_] for k_ in after if after[k_] != before[k_]} == {
            name: 1, f"{name}_bwd": 1}, name
        assert wk.grad is not None and torch.isfinite(wk.grad).all() and wk.grad.abs().sum() > 0
    before = ops.launch_counts()
    big_k = _attention_case(dev, 10, 2, 600, 32, 32, 36, 8, 2)  # 600 rows of 100: 240 KB
    with pytest.raises(ValueError, match="shared memory"):
        ops.temporal_attention(big_k["q3"], big_k["nbr"], big_k["edge"], big_k["phi"],
                               big_k["mask"], big_k["keep"], big_k["wk"], big_k["wv"], 2)
    with pytest.raises(ValueError, match="heads"):
        ops.temporal_attention(t["q3"], t["nbr"], t["edge"], t["phi"], t["mask"], t["keep"],
                               t["wk"], t["wv"], 3)
    with pytest.raises(ValueError, match="dtype"):
        ops.window_attention(t["q3"], t["starts"].long(), t["dt"], t["mask"], t["keep"],
                             t["table"], t["tw"], t["tb"], (t["wk"], t["wv"]), heads)
    with pytest.raises(ValueError, match="on cpu"):
        ops.gathered_attention_backward(
            t["q3"], t["nbr"].reshape(m * k, -1), t["edge"].reshape(m * k, -1), t["dt"],
            t["mask"], t["keep"], (t["tw"], t["tb"]), (t["wk"], t["wv"]),
            torch.zeros((m, 14)), heads)
    with pytest.raises(ValueError, match="shape"):
        ops.temporal_attention_backward(
            t["q3"], t["nbr"], t["edge"], t["phi"], t["mask"], t["keep"], t["wk"], t["wv"],
            torch.zeros((m, 14), device=dev), torch.zeros((m, heads, k + 1), device=dev), heads)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("config", list(TGAT_LAUNCHES))
def test_tgat_configurations_run_their_kernels(dev, config):
    """TGATNet on the card, small widths: each configuration launches its
    kernels (and only those) on inputs as TGAT.sample makes them, and its
    embeddings equal the plain versions' within the kernels' tolerance."""
    tgat, tables, csr, ids, ts = _tgat_case(dev, config)
    kernels = TGAT_LAUNCHES[config]
    net = tgat.build(12, 12, torch.Generator().manual_seed(0)).to(dev).eval()
    inputs = tgat.sample(csr, ids, ts)
    with torch.inference_mode():
        before = ops.launch_counts()
        emb = net(tables, inputs)
        after = ops.launch_counts()
        net.use_kernels = False
        ref = net(tables, inputs)
    torch.cuda.synchronize()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == kernels
    torch.testing.assert_close(emb, ref, atol=ATOL, rtol=0)


def test_uniform_sampling_on_the_card_is_seeded(dev):
    """TGAT under uniform on the card: the same generator seed gives the
    same draws, every draw inside its window, rows all valid or all
    padded; training through the default kernels launches their backward."""
    tgat, tables, csr, ids, ts = _tgat_case(dev, "default", sample_strategy="uniform")
    draw = lambda seed: tgat.sample(csr, ids, ts, gen=torch.Generator(device=dev).manual_seed(seed))
    a, b, c = draw(1), draw(1), draw(2)
    for x, y in zip(a.hop_ids, b.hop_ids):
        assert torch.equal(x, y)
    assert any(not torch.equal(x, y) for x, y in zip(a.hop_ids[1:], c.hop_ids[1:]))
    for mask in a.hop_mask:
        rows = mask.reshape(-1, 5)
        assert torch.equal(rows.all(-1), rows.any(-1))
    net = tgat.build(12, 12, torch.Generator().manual_seed(0)).to(dev)
    before = ops.launch_counts()
    net(tables, a, dropout_gen=torch.Generator(device=dev).manual_seed(0)).square().sum().backward()
    after = ops.launch_counts()
    assert after["gathered_attention_bwd"] - before["gathered_attention_bwd"] == 2
    assert after["temporal_attention_bwd"] - before["temporal_attention_bwd"] == 1


# the kernels a memory model launches per eval batch and per train step;
# DyRep's loss reads the updated memories (its attention only feeds its
# messages), so it runs no attention backward; JODIE has no attention
MEMORY_LAUNCHES = {
    "TGN": ({"temporal_attention": 1}, {"temporal_attention": 1, "temporal_attention_bwd": 1}),
    "DyRep": ({"temporal_attention": 1}, {"temporal_attention": 1}),
    "JODIE": ({}, {}),
}


@pytest.mark.parametrize("name", list(MEMORY_LAUNCHES))
def test_memory_model_launches_per_batch_and_step(dev, name):
    """A memory model at small widths on the card through the trainer: the
    kernel path launches its kernels once per eval batch and train step,
    the plain path none; both paths' probabilities and committed memories
    agree (TGN's and JODIE's memories bitwise: no kernel touches them)."""
    import dataclasses

    from dyglib_tpu_torch.data import synthetic_link_prediction_data
    from dyglib_tpu_torch.models import MemoryModel
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    data = synthetic_link_prediction_data(num_src=60, num_dst=30, num_edges=1500, seed=3)
    data = dataclasses.replace(data, node_raw_features=data.node_raw_features[:, :12].copy(),
                               edge_raw_features=data.edge_raw_features[:, :12].copy())
    tr = LinkPredictionTrainer(
        MemoryModel(model_name=name, memory_dim=12, num_neighbors=5, time_feat_dim=10,
                    dropout=0.0), data, TrainConfig(batch_size=50), device=dev)
    tr.init_params(0)
    params = {part: {k: v.clone() for k, v in sd.items()} for part, sd in tr.state_dicts().items()}
    _, arrays, bucket = next(iter(tr.train_batches()))
    out = {}
    for use_kernels in (True, False):
        tr.load_params(params)
        tr.model.use_kernels = use_kernels
        state = tr.init_state()
        before = ops.launch_counts()
        _, eval_probs, state = tr.eval_step(tr.full_csr, arrays, bucket, state=state)
        mid = ops.launch_counts()
        loss, _, state = tr.train_step(arrays, bucket, state)
        after = ops.launch_counts()
        torch.cuda.synchronize()
        eval_launched = {k: mid[k] - before[k] for k in mid if mid[k] != before[k]}
        train_launched = {k: after[k] - mid[k] for k in after if after[k] != mid[k]}
        want = MEMORY_LAUNCHES[name] if use_kernels else ({}, {})
        assert (eval_launched, train_launched) == want
        assert torch.isfinite(loss)
        out[use_kernels] = (eval_probs, state)
    for a, b in zip(out[True][0], out[False][0]):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    if name == "DyRep":
        torch.testing.assert_close(out[True][1].memory, out[False][1].memory, atol=1e-4, rtol=0)
    else:
        assert torch.equal(out[True][1].memory, out[False][1].memory)
