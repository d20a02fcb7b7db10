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
    "module", ["_build", "time_channel", "cooccurrence", "patch_projection", "window_fetch"]
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
        "time_channel": 0, "time_channel_bwd": 0, "cooccurrence": 0, "patch_projection": 0,
        "patch_projection_bwd": 0, "window_fetch": 0, "temporal_attention": 0,
        "temporal_attention_bwd": 0, "gathered_attention": 0, "gathered_attention_bwd": 0,
        "window_attention": 0, "window_attention_bwd": 0, "phi_projection": 0,
        "phi_projection_bwd": 0,
    }


# ---- backward halves of the time channel and the patch projection
#
# Tolerances: bf16 mode against jax.grad through the JAX custom_vjp
# (interpret mode) at the JAX package's own kernel-vs-oracle gradient
# tolerance: atol 5e-3 relative to the largest gradient entry (both sides
# round the same operands to bf16 and differ in f32 summation order and,
# for the time channel, in the last ulp of cos/sin). f32 mode against
# float64 numpy: 1e-5 relative to the largest entry (sums of <= 200 f32
# products). Finite differences: torch.autograd.gradcheck in float64.


def _rel_close(ours, ref, atol):
    scale = float(np.abs(ref).max()) + 1e-8
    np.testing.assert_allclose(np.asarray(ours) / scale, np.asarray(ref) / scale, atol=atol)


@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced", TIME_CASES)
def test_time_channel_backward_plain_bf16_matches_jax_grad(seed, m, l, patch, dt_dim, ced):
    import jax

    dt, valid, tw, tb, w, bias = _time_case(seed, m, l, patch, dt_dim, ced)
    dout = np.random.RandomState(seed + 10).randn(m, l // patch, ced).astype(np.float32)
    jdt, jvalid, jdout = jnp.asarray(dt), jnp.asarray(valid), jnp.asarray(dout)
    loss = lambda *p: (jax_time_channel_projection(jdt, jvalid, *p, patch) * jdout).sum()
    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (tw, tb, w, bias)))
    ours = ops.time_channel_backward_plain(
        *(torch.from_numpy(a) for a in (dt, valid, tw, tb, w, dout)), patch,
        compute_dtype=torch.bfloat16,
    )
    for got, want in zip(ours, ref):
        assert tuple(got.shape) == tuple(want.shape)
        _rel_close(got.numpy(), want, 5e-3)


@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced", TIME_CASES)
def test_time_channel_backward_f32_matches_numpy(seed, m, l, patch, dt_dim, ced):
    dt, valid, tw, tb, w, bias = _time_case(seed, m, l, patch, dt_dim, ced)
    dout = np.random.RandomState(seed + 10).randn(m, l // patch, ced)
    theta = dt.astype(np.float64)[..., None] * tw + tb
    phi = (np.cos(theta) * valid[..., None]).reshape(-1, patch * dt_dim)
    g = dout.reshape(-1, ced)
    dphi = (g @ w.T.astype(np.float64)).reshape(m, l, dt_dim)
    common = -dphi * np.sin(theta) * valid[..., None]
    want = (
        (common * dt[..., None]).sum((0, 1)), common.sum((0, 1)), phi.T @ g, g.sum(0)
    )
    before = ops.time_channel_backward.launches
    got = ops.time_channel_backward(
        *(torch.from_numpy(a) for a in (dt, valid, tw, tb, w, dout.astype(np.float32))), patch
    )
    assert ops.time_channel_backward.launches == before  # CPU: plain version
    for g_, w_ in zip(got, want):
        _rel_close(g_.numpy(), w_, 1e-5)


@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced", TIME_CASES)
def test_time_channel_autograd_function(seed, m, l, patch, dt_dim, ced):
    """The wrapper's autograd.Function on CPU tensors: gradients for tw, tb,
    w (read as nn.Linear's weight transposed) and bias, none for dt and
    valid, shapes of the inputs, and finite differences agreeing."""
    dt, valid, tw, tb, w, bias = _time_case(seed, m, l, patch, dt_dim, ced)
    t = lambda a: torch.from_numpy(a.astype(np.float64))
    dt_t, valid_t = t(dt), torch.from_numpy(valid != 0)
    tw2 = t(tw).reshape(1, -1).requires_grad_()  # time_encoder.w is (1, Dt)
    params = [t(tb).requires_grad_(), t(w).t().contiguous().requires_grad_(),
              t(bias).requires_grad_()]
    out = ops.time_channel_projection(
        dt_t, valid_t, tw2.reshape(-1), params[0], params[1].t(), params[2], patch
    )
    out.square().sum().backward()
    assert tw2.grad.shape == (1, dt_dim) and params[1].grad.shape == (ced, patch * dt_dim)
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in [tw2] + params)
    assert torch.autograd.gradcheck(
        lambda tw_, tb_, w_, b_: ops.time_channel_projection(dt_t, valid_t, tw_, tb_, w_, b_, patch),
        (t(tw).requires_grad_(), params[0], t(w).requires_grad_(), params[2]),
    )


@pytest.mark.parametrize("seed,m,lp,d,patch,ced", PATCH_CASES)
def test_patch_projection_backward_plain_bf16_matches_jax_grad(seed, m, lp, d, patch, ced):
    import jax

    x, w, b = _patch_case(seed, m, lp, d, patch, ced)
    dout = np.random.RandomState(seed + 10).randn(m, lp // patch, ced).astype(np.float32)
    jx, jdout = jnp.asarray(x), jnp.asarray(dout)
    loss = lambda w_, b_: (jax_patch_projection(jx, w_, b_, patch) * jdout).sum()
    ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(b))
    ours = ops.patch_projection_backward_plain(
        torch.from_numpy(x), torch.from_numpy(dout), patch, compute_dtype=torch.bfloat16
    )
    for got, want in zip(ours, ref):
        assert tuple(got.shape) == tuple(want.shape)
        _rel_close(got.numpy(), want, 5e-3)


@pytest.mark.parametrize("seed,m,lp,d,patch,ced", PATCH_CASES)
def test_patch_projection_backward_f32_and_autograd(seed, m, lp, d, patch, ced):
    x, w, b = _patch_case(seed, m, lp, d, patch, ced)
    dout = np.random.RandomState(seed + 10).randn(m, lp // patch, ced)
    g = dout.reshape(-1, ced)
    want = (x.astype(np.float64).reshape(-1, patch * d).T @ g, g.sum(0))
    before = ops.patch_projection_backward.launches
    got = ops.patch_projection_backward(
        torch.from_numpy(x), torch.from_numpy(dout.astype(np.float32)), patch
    )
    assert ops.patch_projection_backward.launches == before
    for g_, w_ in zip(got, want):
        _rel_close(g_.numpy(), w_, 1e-5)
    # the autograd.Function: dW through nn.Linear's transposed weight, no dx
    t = lambda a: torch.from_numpy(a.astype(np.float64))
    xt = t(x)
    lin_w, bias = t(w).t().contiguous().requires_grad_(), t(b).requires_grad_()
    ops.patch_projection(xt, lin_w.t(), bias, patch).mul(t(dout)).sum().backward()
    _rel_close(lin_w.grad.t().numpy(), want[0], 1e-12)
    _rel_close(bias.grad.numpy(), want[1], 1e-12)
    assert torch.autograd.gradcheck(
        lambda w_, b_: ops.patch_projection(xt, w_, b_, patch),
        (t(w).requires_grad_(), t(b).requires_grad_()),
    )
