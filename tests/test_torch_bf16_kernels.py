"""The bf16 variants of the time channel (#1, #1b) and the patch projection
(#3, #3b), on the CPU.

The CUDA kernels (csrc/time_channel.cu's bf16 entry points on
csrc/time_products.cuh's Bf16 product, csrc/patch_projection_bf16.cu)
run only on the card, where chip_smoke.py holds them to their plain
versions. Here their arithmetic is emulated step by step: operands rounded
to bf16 (to nearest even, as cvt.rn.bf16x2.f32 and torch's .to(bfloat16)),
each 16-deep mma.sync step's products summed in f32, each 32-deep stage's
steps summed into fresh registers and added to the running sum, the
wrapper's splits of the reduction added in order; the patch projection's
output then rounded as TorchLinear(dtype=bfloat16) rounds: the sum to
bf16, plus the bias rounded to bf16, rounded again. The emulations are held

  * to the plain bf16 versions (the wrappers' CPU path): 1e-5 of each
    output's or gradient's largest entry (the same bf16 operands, f32 sums
    in another order); the rounded patch projection equal but for outputs
    that sit on a bf16 rounding boundary, which a last-bit difference of
    the f32 sum may move by one bf16 ulp (at most 1 in 200 here);
  * to the JAX package's Pallas kernels in interpret mode (bf16 operands,
    f32 sums; the time channel's always, the patch projection's the bf16
    model's math): atol 2e-4, the JAX package's own kernel-vs-oracle
    tolerance, and the gradients 5e-3 of the largest entry, its gradient
    tolerance (tests/test_torch_kernels.py); the rounded patch projection
    to the JAX package's bf16 TorchLinear on the patch-flattened rows,
    within one bf16 ulp of the product and one of the output (XLA sums the
    product in its own order, so each of the two roundings may fall on
    the other side of a boundary).

Also the wrappers' helpers: ``copy_values`` (bf16 values a cp.async copy),
the bf16 forward's slots padded to 16 and its plan.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.nn.modules import TorchLinear
from dyglib_tpu.ops.pallas.patch_projection import patch_projection as jax_patch_projection
from dyglib_tpu.ops.pallas.time_channel import time_channel_projection as jax_time_channel
from dyglib_tpu_torch import ops

pp = importlib.import_module("dyglib_tpu_torch.ops.patch_projection")
tc = importlib.import_module("dyglib_tpu_torch.ops.time_channel")
H100_SMS = 132
STAGE, STEP = 32, 16  # the kernels' stage depth (TILE_K) and the bf16 mma's depth
BF16 = torch.bfloat16


def rb(t: torch.Tensor) -> torch.Tensor:
    """f32 holding the bf16 value nearest t (ties to even)."""
    return t.to(BF16).float()


def mma_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (R, K) @ b (K, N), operands already bf16 values, as a block sums
    it: 16-deep steps summed into a 32-deep stage's sum, stages added to
    the running sum."""
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], STAGE):
        part = torch.zeros_like(acc)
        for s in range(k0, min(k0 + STAGE, a.shape[1]), STEP):
            part = part + a[:, s : s + STEP] @ b[s : s + STEP]
        acc = acc + part
    return acc


def split_sum(a, b, chunk):
    """The reduction split into chunks of ``chunk`` (the wrapper's plan),
    each chunk's mma_matmul, the partial sums added in order."""
    out = None
    for k0 in range(0, a.shape[1], chunk):
        part = mma_matmul(a[:, k0 : k0 + chunk], b[k0 : k0 + chunk])
        out = part if out is None else out + part
    return out


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    return torch.ldexp(torch.ones_like(v), torch.frexp(v).exponent - 8)


# ---- the patch projection


def _patch_case(seed, m, lp, d, patch, ced):
    rng = np.random.RandomState(seed)
    k = patch * d
    x = rb(torch.from_numpy(rng.randn(m, lp, d).astype(np.float32)))
    w = torch.from_numpy(rng.uniform(-(k**-0.5), k**-0.5, (k, ced)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-(k**-0.5), k**-0.5, ced).astype(np.float32))
    return x, w, b


def emulated_patch_sum(x, w, patch):
    """The forward kernel's f32 sum before its epilogue (rows, ced)."""
    m, lp, d = x.shape
    rows, k = m * (lp // patch), patch * d
    _, chunk = pp.forward_plan(rows, k, w.shape[1], H100_SMS)
    return split_sum(x.reshape(rows, k), rb(w), chunk)


def emulated_patch_forward(x, w, bias, patch):
    m, lp, _ = x.shape
    out = rb(rb(emulated_patch_sum(x, w, patch)) + rb(bias))
    return out.reshape(m, lp // patch, -1)


def emulated_patch_backward(x, dout, patch):
    """[x | 1]^T @ dout (bf16 values) over the wrapper's row chunks."""
    m, lp, d = x.shape
    rows, k = m * (lp // patch), patch * d
    ced = dout.shape[-1]
    a = torch.cat([x.reshape(rows, k), torch.ones((rows, 1))], 1).t()
    chunk = pp.backward_chunk_rows(rows, k, ced, H100_SMS)
    ext = split_sum(a, rb(dout.reshape(rows, ced)), chunk)
    return ext[:k], ext[k]


# (seed, M, Lp, D, patch, ced): patch > 1 with a K split, patch 1, an odd
# D (K odd: one-value copies), ragged rows and ced
PATCH_CASES = [(0, 4, 64, 12, 16, 10), (1, 40, 8, 172, 1, 50), (2, 5, 12, 7, 1, 9),
               (3, 3, 512, 172, 64, 50)]


@pytest.mark.parametrize("seed,m,lp,d,patch,ced", PATCH_CASES)
def test_emulated_patch_forward_matches_plain_and_jax(seed, m, lp, d, patch, ced):
    x, w, b = _patch_case(seed, m, lp, d, patch, ced)
    emu = emulated_patch_forward(x, w, b, patch)
    before = ops.KERNELS["patch_projection_bf16"].launches
    plain = ops.patch_projection(x.to(BF16), w, b, patch, BF16)
    assert ops.KERNELS["patch_projection_bf16"].launches == before  # CPU: the plain version
    assert plain.dtype == BF16 and plain.shape == emu.shape == (m, lp // patch, ced)
    plain = plain.float()
    off = (emu != plain).float().mean().item()
    assert off <= 1 / 200 and ((emu - plain).abs() <= bf16_ulp(plain)).all()
    # the JAX bf16 model's frozen channel: TorchLinear(bfloat16) on the patches
    lin = TorchLinear(ced, dtype=jnp.bfloat16)
    flat = jnp.asarray(x.numpy()).reshape(m * (lp // patch), patch * d)
    want = np.asarray(lin.apply({"params": {"kernel": jnp.asarray(w.numpy()),
                                            "bias": jnp.asarray(b.numpy())}}, flat),
                      np.float32).reshape(emu.shape)
    product = emulated_patch_sum(x, w, patch).reshape(emu.shape)
    one_each = (bf16_ulp(product) + bf16_ulp(torch.from_numpy(want))).numpy()
    assert (np.abs(emu.numpy() - want) <= one_each).all()
    # the Pallas kernel (interpret mode): the same sum, the bias added in f32
    kernel = np.asarray(jax_patch_projection(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                                             jnp.asarray(b.numpy()), patch))
    unrounded = product + b
    np.testing.assert_allclose(unrounded.numpy(), kernel, atol=2e-4, rtol=0)


@pytest.mark.parametrize("seed,m,lp,d,patch,ced", PATCH_CASES)
def test_emulated_patch_backward_matches_plain_and_jax(seed, m, lp, d, patch, ced):
    x, w, b = _patch_case(seed, m, lp, d, patch, ced)
    dout = rb(torch.from_numpy(np.random.RandomState(seed + 10)
                               .randn(m, lp // patch, ced).astype(np.float32)))
    emu = emulated_patch_backward(x, dout, patch)
    before = ops.KERNELS["patch_projection_bf16_bwd"].launches
    plain = ops.patch_projection_backward(x.to(BF16), dout.to(BF16), patch, BF16)
    assert ops.KERNELS["patch_projection_bf16_bwd"].launches == before
    jx, jdout = jnp.asarray(x.numpy()), jnp.asarray(dout.numpy())
    loss = lambda w_, b_: (jax_patch_projection(jx, w_, b_, patch) * jdout).sum()
    ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w.numpy()), jnp.asarray(b.numpy()))
    for e, p_, r in zip(emu, plain, ref):
        assert p_.dtype == torch.float32 and p_.shape == e.shape == r.shape
        scale = float(np.abs(np.asarray(r)).max())
        np.testing.assert_allclose(e.numpy() / scale, p_.numpy() / scale, atol=1e-5, rtol=0)
        np.testing.assert_allclose(e.numpy() / scale, np.asarray(r) / scale, atol=5e-3, rtol=0)


def test_patch_projection_autograd_in_bf16():
    """The autograd.Function's bf16 path: a bf16 output, f32 gradients for
    w and bias (the bf16 backward's), none for x."""
    x, w, b = _patch_case(4, 3, 16, 6, 4, 5)
    w, b = w.requires_grad_(), b.requires_grad_()
    out = ops.patch_projection(x.to(BF16), w, b, 4, compute_dtype=BF16)
    assert out.dtype == BF16
    g = torch.randn(out.shape).to(BF16)
    (out * g).float().sum().backward()
    dw, db = ops.patch_projection_backward_plain(x, g.float(), 4, BF16)
    torch.testing.assert_close(w.grad, dw, rtol=0, atol=0)
    torch.testing.assert_close(b.grad, db, rtol=0, atol=0)
    with pytest.raises(ValueError, match="compute dtype"):
        ops.patch_projection(x, w, b, 4, compute_dtype=torch.float16)


# ---- the time channel


def _time_case(seed, m, l, patch, dt_dim, ced):
    rng = np.random.RandomState(seed)
    k = patch * dt_dim
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    dt = t(np.floor(rng.rand(m, l) * 100))
    valid = torch.from_numpy(rng.rand(m, l) > 0.2)
    tw = t(1.0 / 10 ** np.linspace(0, 9, dt_dim))
    tb = t(rng.randn(dt_dim) * 0.1)
    w = t(rng.uniform(-(k**-0.5), k**-0.5, (k, ced)))
    bias = t(rng.uniform(-(k**-0.5), k**-0.5, ced))
    return dt, valid, tw, tb, w, bias


def _padded(phi, w, patch, dt_dim, step):
    """Phi (rows, patch * Dt) and W with each slot's features padded to
    padded_dt(Dt, step) with zeros, as the kernels lay the K axis out."""
    dt_pad = tc.padded_dt(dt_dim, step)
    rows = phi.shape[0]
    a = torch.zeros((rows, patch, dt_pad))
    a[..., :dt_dim] = phi.reshape(rows, patch, dt_dim)
    bw = torch.zeros((patch, dt_pad, w.shape[1]))
    bw[:, :dt_dim] = w.reshape(patch, dt_dim, -1)
    return a.reshape(rows, -1), bw.reshape(patch * dt_pad, -1)


def _phi(dt, valid, tw, tb, patch):
    m, l = dt.shape
    theta = dt[..., None] * tw + tb
    phi = torch.where(valid[..., None], torch.cos(theta), 0.0)
    return phi.reshape(m * (l // patch), patch * tw.shape[0]), theta


def emulated_time_forward(dt, valid, tw, tb, w, bias, patch):
    m, l = dt.shape
    dt_dim, ced = tw.shape[0], w.shape[1]
    phi, _ = _phi(dt, valid, tw, tb, patch)
    a, bw = _padded(rb(phi), rb(w), patch, dt_dim, tc.BF16_DT_STEP)
    chunk = tc.forward_plan(a.shape[0], patch, dt_dim, ced, H100_SMS, tc.BF16_DT_STEP)
    return (split_sum(a, bw, chunk) + bias).reshape(m, l // patch, ced)


def emulated_time_backward(dt, valid, tw, tb, w, dout, patch):
    """(dtw, dtb, dW, dbias): dW = Phi^T dout over 32-row stages of 16-row
    steps, dPhi = dout W^T over ced padded to 64 in 16-deep steps, both on
    bf16 operands; c = dPhi * -sin summed in f32; dbias = sum of f32 dout."""
    m, l = dt.shape
    dt_dim, ced = tw.shape[0], w.shape[1]
    rows, k = m * (l // patch), patch * dt_dim
    phi, theta = _phi(dt, valid, tw, tb, patch)
    g = dout.reshape(rows, ced)
    g64 = torch.zeros((rows, 64 * -(-ced // 56)))
    g64[:, :ced] = rb(g)
    w64 = torch.zeros((k, g64.shape[1]))
    w64[:, :ced] = rb(w)
    chunk = tc.backward_chunk_rows(rows, patch, dt_dim, ced, H100_SMS)
    dw = split_sum(rb(phi).t(), rb(g), chunk)
    dphi = mma_matmul(g64, w64.t()).reshape(m, l, dt_dim)
    common = torch.where(valid[..., None], dphi * -torch.sin(theta), 0.0)
    return (common * dt[..., None]).sum((0, 1)), common.sum((0, 1)), dw, g.sum(0)


# (seed, M, L, patch, Dt, ced): ragged Dt and ced, the wikipedia slot (Dt
# 100 padded to 112, patch 1), CanParl's patch on a few rows (K = 6400)
TIME_CASES = [(0, 7, 12, 4, 6, 9), (1, 40, 32, 1, 100, 50), (2, 3, 2048, 64, 100, 50)]


@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced", TIME_CASES)
def test_emulated_time_forward_matches_plain_and_jax(seed, m, l, patch, dt_dim, ced):
    args = _time_case(seed, m, l, patch, dt_dim, ced)
    emu = emulated_time_forward(*args, patch)
    before = ops.KERNELS["time_channel_bf16"].launches
    plain = ops.time_channel_projection(*args, patch, compute_dtype=BF16)
    assert ops.KERNELS["time_channel_bf16"].launches == before
    assert plain.dtype == torch.float32 and plain.shape == emu.shape == (m, l // patch, ced)
    scale = float(plain.abs().max())
    torch.testing.assert_close(emu / scale, plain / scale, atol=1e-5, rtol=0)
    dt, valid, tw, tb, w, bias = (jnp.asarray(a.numpy()) for a in args)
    kernel = np.asarray(jax_time_channel(dt, valid.astype(jnp.float32), tw, tb, w, bias, patch))
    np.testing.assert_allclose(emu.numpy(), kernel, atol=2e-4, rtol=0)


@pytest.mark.parametrize("seed,m,l,patch,dt_dim,ced", TIME_CASES)
def test_emulated_time_backward_matches_plain_and_jax(seed, m, l, patch, dt_dim, ced):
    dt, valid, tw, tb, w, bias = _time_case(seed, m, l, patch, dt_dim, ced)
    dout = torch.from_numpy(np.random.RandomState(seed + 10)
                            .randn(m, l // patch, ced).astype(np.float32))
    emu = emulated_time_backward(dt, valid, tw, tb, w, dout, patch)
    before = ops.KERNELS["time_channel_bf16_bwd"].launches
    plain = ops.time_channel_backward(dt, valid, tw, tb, w, dout, patch, BF16)
    assert ops.KERNELS["time_channel_bf16_bwd"].launches == before
    jdt, jvalid, jdout = (jnp.asarray(a) for a in (dt.numpy(), valid.numpy().astype(np.float32),
                                                   dout.numpy()))
    loss = lambda *p: (jax_time_channel(jdt, jvalid, *p, patch) * jdout).sum()
    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a.numpy())
                                                 for a in (tw, tb, w, bias)))
    for e, p_, r in zip(emu, plain, ref):
        r = np.asarray(r)
        assert p_.shape == e.shape == r.shape
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(e.numpy() / scale, p_.numpy() / scale, atol=1e-5, rtol=0)
        np.testing.assert_allclose(e.numpy() / scale, r / scale, atol=5e-3, rtol=0)


# ---- the wrappers' helpers


@pytest.mark.parametrize("stride,offset,want", [(172, 0, 4), (176, 0, 8), (50, 0, 2), (1, 0, 1),
                                                (176, 1, 1), (176, 2, 2), (176, 4, 4)])
def test_copy_values_is_the_widest_aligned_copy(stride, offset, want):
    base = torch.zeros(4096, dtype=BF16)
    assert base.data_ptr() % 16 == 0
    assert pp.copy_values(base[offset:], stride) == want


@pytest.mark.parametrize("dt_dim,want", [(1, 16), (16, 16), (100, 112), (101, 112)])
def test_bf16_slots_are_padded_to_the_mma_depth(dt_dim, want):
    assert tc.padded_dt(dt_dim, tc.BF16_DT_STEP) == want
    assert tc.padded_dt(dt_dim) == -(-dt_dim // 8) * 8  # the f32 forward's, unchanged


@pytest.mark.parametrize("rows,patch,dt_dim,ced", [(19200, 64, 100, 50), (19200, 1, 100, 50),
                                                   (7, 4, 6, 9)])
def test_bf16_forward_plan_is_whole_stages_and_covers_k(rows, patch, dt_dim, ced):
    kp = patch * tc.padded_dt(dt_dim, tc.BF16_DT_STEP)
    chunk = tc.forward_plan(rows, patch, dt_dim, ced, H100_SMS, tc.BF16_DT_STEP)
    assert chunk % STAGE == 0 and 0 < chunk and -(-kp // chunk) * chunk >= kp
