"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. They run on the
GPU machine, which has no JAX (so ``tests/conftest.py`` cannot load):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

chip_smoke.py holds each kernel to its plain version at the main path's
shapes; these cases cover the edges those shapes miss: row counts that are
not a multiple of the 64-row tile, ced above one 64-column tile, K not a
multiple of the 16-deep slice, keys longer than one 2048-id shared-memory
chunk, more queries than one 256-thread block, both weight layouts the
GEMM kernels read (row-major (K, ced) and nn.Linear's (ced, K) transposed),
and the wrappers' refusals.

Tolerances: time_channel and patch_projection atol 1e-4 (both sides are
f32; they differ only in the order of the f32 sums, K <= 1100 products of
O(1) values); cooccurrence counts are integers and must match exactly.
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


@pytest.mark.parametrize("layout", ["rows", "linear"])
@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced,scale", TIME_CASES)
def test_time_channel_kernel_matches_plain(dev, seed, m, l, patch, dt_dim, ced, scale, layout):
    rng = np.random.RandomState(seed)
    dt = np.floor(rng.rand(m, l) * scale).astype(np.float32)
    valid = rng.rand(m, l) > 0.3
    tw = (1.0 / 10 ** np.linspace(0, 9, dt_dim)).astype(np.float32)
    tb = (rng.randn(dt_dim) * 0.1).astype(np.float32)
    w = (rng.randn(patch * dt_dim, ced) * (patch * dt_dim) ** -0.5).astype(np.float32)
    bias = rng.randn(ced).astype(np.float32)
    dt, valid, tw, tb, w, bias = _on(dev, dt, valid, tw, tb, w, bias)
    args = (dt, valid, tw, tb, _layout(w, layout), bias, patch)
    before = ops.time_channel_projection.launches
    out = ops.time_channel_projection(*args)
    assert ops.time_channel_projection.launches == before + 1
    ref = ops.time_channel_projection_plain(*args)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (m, l // patch, ced)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


# (seed, M, Lp, D, patch, ced)
PATCH_CASES = [
    (0, 5, 12, 7, 3, 9),  # K = 21: a ragged last K slice
    (1, 70, 32, 172, 1, 50),  # two row tiles, the second ragged
    (2, 11, 64, 17, 64, 100),  # K = 1088, ced 100: two column tiles
]


@pytest.mark.parametrize("layout", ["rows", "linear"])
@pytest.mark.parametrize("seed,m,lp,d,patch,ced", PATCH_CASES)
def test_patch_projection_kernel_matches_plain(dev, seed, m, lp, d, patch, ced, layout):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, lp, d).astype(np.float32)
    x[:, lp // 2 :] = 0.0  # zero pad rows, as the gathered sentinel rows are
    w = (rng.randn(patch * d, ced) * (patch * d) ** -0.5).astype(np.float32)
    bias = rng.randn(ced).astype(np.float32)
    x, w, bias = _on(dev, x, w, bias)
    args = (x, _layout(w, layout), bias, patch)
    before = ops.patch_projection.launches
    out = ops.patch_projection(*args)
    assert ops.patch_projection.launches == before + 1
    ref = ops.patch_projection_plain(*args)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (m, lp // patch, ced)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


# (seed, R, Lq, Lk, id range)
CO_CASES = [
    (0, 3, 300, 5000, 50),  # Lq over one block, Lk over two key chunks
    (1, 17, 1, 37, 4),  # a single query position
    (2, 5, 2048, 2048, 300),  # the main path's self counts, one full chunk
    (3, 4, 33, 4097, 7),  # Lk one past two chunks
]


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
