"""Port kernels (dyglib_tpu_torch/ops) against the JAX package on the CPU.

On the CPU each wrapper takes its plain PyTorch version, so these tests
hold the plain versions to the JAX functions: the Pallas kernels in
interpret mode (as their own tests run them here) and their ``*_reference``
oracles. The CUDA kernels themselves are held to the plain versions on the
card by chip_smoke.py.

Tolerances:
  * bf16 mode (operands rounded to bf16, f32 accumulation, the TPU
    kernels' math): atol 2e-4, the JAX package's own kernel-vs-oracle
    tolerance; both sides round the same operands and differ only in the
    f32 summation order (and, for the time channel, in the last ulp of cos,
    which can flip a rare bf16 rounding);
  * f32 mode against a float64 numpy computation: atol 1e-5 (K <= 192
    products of O(1) values in f32);
  * co-occurrence counts are integers: exact.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.ops.pallas.cooccurrence import (
    cooccurrence_counts as jax_cooccurrence_counts,
)
from dyglib_tpu.ops.pallas.patch_projection import (
    patch_projection as jax_patch_projection,
    patch_projection_reference,
)
from dyglib_tpu.ops.pallas.time_channel import (
    time_channel_projection as jax_time_channel_projection,
    time_channel_projection_reference,
)
from dyglib_tpu_torch import ops


def _time_case(seed, m, l, patch, dt_dim, ced):
    rng = np.random.RandomState(seed)
    dt = (rng.rand(m, l) * 100).astype(np.float32)
    valid = (rng.rand(m, l) > 0.3).astype(np.float32)
    tw = (rng.randn(dt_dim) * 0.1).astype(np.float32)
    tb = rng.randn(dt_dim).astype(np.float32)
    w = (rng.randn(patch * dt_dim, ced) * 0.1).astype(np.float32)
    bias = (rng.randn(ced) * 0.1).astype(np.float32)
    return dt, valid, tw, tb, w, bias


# (seed, M, L, patch, Dt, ced): patch > 1, patch 1, and ragged row counts
TIME_CASES = [(0, 6, 32, 8, 10, 12), (1, 5, 8, 1, 10, 12), (2, 7, 12, 4, 6, 9)]


@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced", TIME_CASES)
def test_time_channel_plain_bf16_matches_jax(seed, m, l, patch, dt_dim, ced):
    arrays = _time_case(seed, m, l, patch, dt_dim, ced)
    ours = ops.time_channel_projection_plain(
        *(torch.from_numpy(a) for a in arrays), patch, compute_dtype=torch.bfloat16
    ).numpy()
    jargs = [jnp.asarray(a) for a in arrays]
    kernel = np.asarray(jax_time_channel_projection(*jargs, patch))  # interpret mode
    oracle = np.asarray(time_channel_projection_reference(*jargs, patch))
    assert ours.shape == (m, l // patch, ced)
    np.testing.assert_allclose(ours, kernel, atol=2e-4)
    np.testing.assert_allclose(ours, oracle, atol=2e-4)


@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced", TIME_CASES)
def test_time_channel_wrapper_f32_on_cpu(seed, m, l, patch, dt_dim, ced):
    dt, valid, tw, tb, w, bias = _time_case(seed, m, l, patch, dt_dim, ced)
    before = ops.time_channel_projection.launches
    ours = ops.time_channel_projection(
        *(torch.from_numpy(a) for a in (dt, valid, tw, tb, w, bias)), patch
    ).numpy()
    assert ops.time_channel_projection.launches == before  # CPU: plain version
    phi = np.cos(dt.astype(np.float64)[..., None] * tw + tb) * valid[..., None]
    ref = phi.reshape(m * (l // patch), patch * dt_dim) @ w + bias
    np.testing.assert_allclose(ours.reshape(-1, ced), ref, atol=1e-5)


def _patch_case(seed, m, lp, d, patch, ced):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, lp, d).astype(np.float32)
    w = (rng.randn(patch * d, ced) * 0.1).astype(np.float32)
    b = rng.randn(ced).astype(np.float32)
    return x, w, b


# (seed, M, Lp, D, patch, ced): patch > 1, patch 1, ragged rows
PATCH_CASES = [(0, 4, 64, 12, 16, 10), (1, 3, 8, 12, 1, 10), (2, 5, 12, 7, 4, 9)]


@pytest.mark.parametrize("seed,m,lp,d,patch,ced", PATCH_CASES)
def test_patch_projection_plain_bf16_matches_jax(seed, m, lp, d, patch, ced):
    arrays = _patch_case(seed, m, lp, d, patch, ced)
    ours = ops.patch_projection_plain(
        *(torch.from_numpy(a) for a in arrays), patch, compute_dtype=torch.bfloat16
    ).numpy()
    jargs = [jnp.asarray(a) for a in arrays]
    kernel = np.asarray(jax_patch_projection(*jargs, patch))  # interpret mode
    oracle = np.asarray(patch_projection_reference(*jargs, patch))
    assert ours.shape == (m, lp // patch, ced)
    np.testing.assert_allclose(ours, kernel, atol=2e-4)
    np.testing.assert_allclose(ours, oracle, atol=2e-4)


@pytest.mark.parametrize("seed,m,lp,d,patch,ced", PATCH_CASES)
def test_patch_projection_wrapper_f32_on_cpu(seed, m, lp, d, patch, ced):
    x, w, b = _patch_case(seed, m, lp, d, patch, ced)
    before = ops.patch_projection.launches
    ours = ops.patch_projection(*(torch.from_numpy(a) for a in (x, w, b)), patch).numpy()
    assert ops.patch_projection.launches == before
    ref = x.astype(np.float64).reshape(m * (lp // patch), patch * d) @ w + b
    np.testing.assert_allclose(ours.reshape(-1, ced), ref, atol=1e-5)


# (seed, R, Lq, Lk, id range): Lq != Lk both ways, self counts (Lq == Lk)
CO_CASES = [(0, 5, 37, 20, 9), (1, 3, 8, 40, 5), (2, 9, 32, 32, 12)]


@pytest.mark.parametrize("seed,r,lq,lk,ids", CO_CASES)
def test_cooccurrence_counts_exact(seed, r, lq, lk, ids):
    rng = np.random.RandomState(seed)
    q = rng.randint(0, ids, size=(r, lq)).astype(np.int32)
    k = rng.randint(0, ids, size=(r, lk)).astype(np.int32)
    before = ops.cooccurrence_counts.launches
    ours = ops.cooccurrence_counts(torch.from_numpy(q), torch.from_numpy(k)).numpy()
    assert ops.cooccurrence_counts.launches == before
    jx = np.asarray(jax_cooccurrence_counts(jnp.asarray(q), jnp.asarray(k), interpret=True))
    assert ours.dtype == np.float32 and ours.shape == (r, lq)
    np.testing.assert_array_equal(ours, jx)
    own = ops.cooccurrence_counts(torch.from_numpy(q), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(
        own, np.asarray(jax_cooccurrence_counts(jnp.asarray(q), jnp.asarray(q), interpret=True))
    )


@pytest.mark.parametrize(
    "module", ["_build", "time_channel", "cooccurrence", "patch_projection"]
)
def test_ops_modules_import_without_nvcc(module):
    """Importing a kernel module compiles and loads nothing."""
    mod = importlib.import_module(f"dyglib_tpu_torch.ops.{module}")
    assert mod is not None
    from dyglib_tpu_torch.ops import _build

    assert _build._libs == {}


def test_wrapper_rejects_other_devices():
    """A tensor on neither the CPU nor CUDA is refused, never computed."""
    meta = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError):
        ops.cooccurrence_counts(meta.to(torch.int32), meta.to(torch.int32))


def test_launch_counters_reset():
    ops.time_channel_projection.launches = 3
    ops.reset_launch_counts()
    assert ops.launch_counts() == {
        "time_channel": 0, "cooccurrence": 0, "patch_projection": 0
    }
