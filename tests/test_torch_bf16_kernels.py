"""The bf16 variants of the time channel (#1, #1b) and the patch projection
(#3, #3b), on the CPU.

The CUDA kernels (csrc/time_channel.cu's bf16 entry points, the forward
and csrc/time_channel_bf16_bwd.cuh's backward, both on wgmma;
csrc/patch_projection_bf16.cu, the forward on wgmma and the backward on
mma.sync) run only on the card, where chip_smoke.py holds them to their
plain versions. Here their arithmetic is emulated step by step: operands
rounded to bf16 (to nearest even, as cvt.rn.bf16x2.f32 and torch's
.to(bfloat16)), each 16-deep step's products summed in f32, each stage's
steps summed into fresh registers and added to the running sum (32-deep
stages on mma.sync, 64-deep in the patch projection's wgmma forward and
the time channel's wgmma backward, whose dPhi is one 64-column stage a
column tile; the time channel's wgmma forward sums a whole split's steps
on the tensor cores), the wrapper's splits of the reduction added in
order, the time backward's entries laid out as its wrapper lays them; the patch
projection's output then rounded as TorchLinear(dtype=bfloat16) rounds:
the sum to bf16, plus the bias rounded to bf16, rounded again. The
emulations are held

  * to the plain bf16 versions (the wrappers' CPU path): 1e-5 of each
    output's or gradient's largest entry (the same bf16 operands, f32 sums
    in another order); the rounded patch projection one rounding at a
    time: the product rounded to bf16 equal but for products that sit on
    a bf16 rounding boundary (at most 1 in 200 here), which a last-bit
    difference of the f32 sum may move by one bf16 ulp, and each output
    exactly TorchLinear's second rounding of its rounded product (the sum
    with the rounded bias, rounded), so that outputs differ only where
    their products' roundings do (at most 1 in 200);
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
the bf16 forward's slots padded to 16, the plans (the time backward's row
chunks among them), the time backward's entry layout, TMA's rule for x's
rows and the padded copy where it fails, the packed bf16 W^T and the time
forward's choice to convert W in its blocks.
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
# the stage depth of the mma.sync backwards (TILE_K) and of the wgmma
# forwards (WGMMA_STAGE_K), and the bf16 mma's depth
STAGE, WGMMA_STAGE, STEP = 32, 64, 16
BF16 = torch.bfloat16


def rb(t: torch.Tensor) -> torch.Tensor:
    """f32 holding the bf16 value nearest t (ties to even)."""
    return t.to(BF16).float()


def mma_matmul(a: torch.Tensor, b: torch.Tensor, stage: int = STAGE) -> torch.Tensor:
    """a (R, K) @ b (K, N), operands already bf16 values, as a block sums
    it: 16-deep steps summed into a ``stage``-deep stage's sum, stages added
    to the running sum."""
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], stage):
        part = torch.zeros_like(acc)
        for s in range(k0, min(k0 + stage, a.shape[1]), STEP):
            part = part + a[:, s : s + STEP] @ b[s : s + STEP]
        acc = acc + part
    return acc


def split_sum(a, b, chunk, stage: int = STAGE):
    """The reduction split into chunks of ``chunk`` (the wrapper's plan),
    each chunk's mma_matmul, the partial sums added in order."""
    out = None
    for k0 in range(0, a.shape[1], chunk):
        part = mma_matmul(a[:, k0 : k0 + chunk], b[k0 : k0 + chunk], stage)
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
    chunk = pp.wgmma_forward_plan(rows, k, w.shape[1], H100_SMS)
    return split_sum(x.reshape(rows, k), rb(w), chunk, WGMMA_STAGE)


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
    # the first rounding, the product's: one bf16 ulp at most, where the f32
    # sums' last bits put them on two sides of a boundary
    product = emulated_patch_sum(x, w, patch).reshape(emu.shape)
    plain_product = ops.patch_projection_plain(x.to(BF16), w, torch.zeros_like(b), patch, BF16)
    p_emu, p_plain = rb(product), rb(plain_product)
    off = (p_emu != p_plain).float().mean().item()
    assert off <= 1 / 200 and ((p_emu - p_plain).abs() <= bf16_ulp(p_plain)).all()
    # the second, TorchLinear's: the rounded product plus the rounded bias,
    # rounded; exact for both, so the outputs differ only where the products did
    second = lambda p: (p.to(BF16) + b.to(BF16)).float()
    assert torch.equal(emu, second(p_emu)) and torch.equal(plain, second(p_plain))
    assert (emu != plain).float().mean().item() <= off
    # the JAX bf16 model's frozen channel: TorchLinear(bfloat16) on the patches
    lin = TorchLinear(ced, dtype=jnp.bfloat16)
    flat = jnp.asarray(x.numpy()).reshape(m * (lp // patch), patch * d)
    want = np.asarray(lin.apply({"params": {"kernel": jnp.asarray(w.numpy()),
                                            "bias": jnp.asarray(b.numpy())}}, flat),
                      np.float32).reshape(emu.shape)
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
    chunk = tc.wgmma_forward_plan(a.shape[0], patch, dt_dim, ced, H100_SMS)
    return (split_sum(a, bw, chunk, chunk) + bias).reshape(m, l // patch, ced)


def emulated_time_backward(dt, valid, tw, tb, w, dout, patch):
    """(dtw, dtb, dW, dbias) as the wgmma backward sums them, on bf16 Phi,
    dout and W: the K entries laid out at bf16_entry_pad(Dt) apart in each
    patch slot (padded entries zero); per 64-column tile of dout (ced
    padded with zeros), dPhi^T = W_tile dout_tile^T in 16-deep steps (one
    stage) and c = where(valid, dPhi * -sin), the tiles' c added; dW =
    Phi^T dout over the plan's row chunks, each a run of 64-row stages of
    16-row steps, each stage into a fresh sum, the chunks added in order;
    dbias = the sum of the f32 dout."""
    m, l = dt.shape
    dt_dim, ced = tw.shape[0], w.shape[1]
    rows, k = m * (l // patch), patch * dt_dim
    dt_pad, cols = tc.bf16_entry_pad(dt_dim), tc.BF16_BWD_COLS
    phi, theta = _phi(dt, valid, tw, tb, patch)
    g = dout.reshape(rows, ced)
    a, bw = _padded(rb(phi), rb(w), patch, dt_dim, dt_pad)  # (rows, entries), (entries, ced)
    g_pad = torch.zeros((rows, cols * -(-ced // cols)))
    g_pad[:, :ced] = rb(g)
    w_pad = torch.zeros((bw.shape[0], g_pad.shape[1]))
    w_pad[:, :ced] = bw
    common = 0.0
    for c0 in range(0, g_pad.shape[1], cols):
        dphi_t = mma_matmul(w_pad[:, c0 : c0 + cols], g_pad[:, c0 : c0 + cols].t(), WGMMA_STAGE)
        dphi = dphi_t.t().reshape(rows, patch, dt_pad)[..., :dt_dim].reshape(m, l, dt_dim)
        common = common + torch.where(valid[..., None], dphi * -torch.sin(theta), 0.0)
    chunk = tc.wgmma_backward_plan(rows, patch, dt_dim, ced, H100_SMS)
    dw = split_sum(a.t(), rb(g), chunk, WGMMA_STAGE)
    dw = dw.reshape(patch, dt_pad, ced)[:, :dt_dim].reshape(k, ced)
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
    chunk = tc.wgmma_forward_plan(rows, patch, dt_dim, ced, H100_SMS)
    assert chunk % WGMMA_STAGE == 0 and 0 < chunk and -(-kp // chunk) * chunk >= kp
    assert -(-kp // chunk) == 1 or -(-kp // chunk) * chunk - kp < chunk  # no empty split


@pytest.mark.parametrize("rows,patch,dt_dim,ced,one_chunk", [
    (19200, 64, 100, 50, False),  # CanParl: 50 entry tiles, 300 stages
    (19200, 1, 100, 50, False),  # wikipedia: one entry tile
    (7, 4, 6, 9, True),  # one stage
    (19200, 132, 128, 50, True),  # 132 entry tiles: one chunk fills the card
    (64 * 70000, 1, 100, 50, False),  # more stages than the grid's z takes chunks
])
def test_bf16_backward_plan_is_whole_stages_and_covers_rows(rows, patch, dt_dim, ced, one_chunk):
    """The bf16 time backward's row chunks: whole 64-row stages, every row
    covered with no empty chunk, at most the grid's z limit of chunks, and
    one chunk where its blocks already fill the card or the rows are one
    stage."""
    chunk = tc.wgmma_backward_plan(rows, patch, dt_dim, ced, H100_SMS)
    chunks = -(-rows // chunk)
    assert chunk % tc.BF16_BWD_ROWS == 0 and 0 < chunk and chunks * chunk >= rows
    assert chunks == 1 or chunks * chunk - rows < chunk
    assert chunks <= 65535
    assert (chunks == 1) is one_chunk


def slots_bound(dt_pad):
    """csrc/time_channel_bf16_bwd.cuh::slots_bound, which the kernel's entry
    point checks against its 8 slots a block."""
    e = tc.BF16_BWD_ENTRIES
    return e // dt_pad if e % dt_pad == 0 else (e - 1) // dt_pad + 2


@pytest.mark.parametrize("dt_dim,want", [(100, 100), (19, 19), (18, 32), (6, 16), (1, 16),
                                         (101, 101), (128, 128)])
def test_bf16_backward_entries_are_unpadded_where_a_block_spans_few_slots(dt_dim, want):
    """The bf16 time backward lays each slot's Dt features out unpadded
    where a block's 128 entries span at most 8 slots, else padded to 16:
    either way within the kernel's 8 slots a block, whose bound is every
    block's span counted."""
    assert tc.bf16_entry_pad(dt_dim) == want
    assert slots_bound(want) <= tc.BF16_BWD_MAX_SLOTS
    # every block's span: entries e0 .. e0 + 127 at slots e // want
    spans = {(e0 + tc.BF16_BWD_ENTRIES - 1) // want - e0 // want + 1
             for e0 in range(0, 64 * want * tc.BF16_BWD_ENTRIES, tc.BF16_BWD_ENTRIES)}
    assert max(spans) == slots_bound(want)


@pytest.mark.parametrize("rows,k,ced", [(19200, 11008, 50), (19200, 344, 50), (12, 192, 10),
                                        (5, 64, 130)])
def test_wgmma_patch_plan_is_whole_stages_and_covers_k(rows, k, ced):
    chunk = pp.wgmma_forward_plan(rows, k, ced, H100_SMS)
    assert chunk % WGMMA_STAGE == 0 and 0 < chunk and -(-k // chunk) * chunk >= k
    assert -(-k // chunk) == 1 or -(-k // chunk) * chunk - k < chunk


def test_wgmma_split_weighs_waves_against_partial_sums():
    """A reduction that fills the card stays whole; one whose blocks fill a
    fraction of it is split; heavy partial sums push back toward one
    split; ties go to fewer splits."""
    assert tc.wgmma_split(264, 100, 132, 0.0) == 100  # two waves either way: whole
    per = tc.wgmma_split(75, 172, 132, 0.0)
    assert per < 172 and -(-172 // per) > 1
    assert tc.wgmma_split(75, 172, 132, 1e9) == 172
    assert tc.wgmma_split(1, 1, 132, 0.0) == 1


@pytest.mark.parametrize("rows,patch,dt_dim,ced,resident", [
    (19200, 1, 100, 50, True),  # wikipedia: 112 padded K, one split of two stages
    (19200, 64, 100, 50, False),  # CanParl: splits of 23 stages
    (5 * 32, 64, 100, 50, True),  # a few rows: one-stage splits
    (19200, 8, 100, 50, False),  # 896 padded K in one split
])
def test_time_forward_converts_w_in_its_blocks_where_a_split_is_small(
        rows, patch, dt_dim, ced, resident):
    """The bf16 time forward packs no W^T (no scratch, no second launch)
    where each split's W is two stages at most, which its blocks convert."""
    chunk = tc.wgmma_forward_plan(rows, patch, dt_dim, ced, H100_SMS)
    assert tc.resident_weight(chunk) is resident
    assert resident == (chunk <= 2 * WGMMA_STAGE)


@pytest.mark.parametrize("k,address,want", [(11008, 0, True), (11008, 16, True), (172, 0, False),
                                            (344, 0, True), (516, 0, False), (11008, 8, False),
                                            (192, 2, False)])
def test_tma_accepts_rows_of_16_byte_multiples(k, address, want):
    """TMA's rule for x (rows of k bf16 values): the row stride (2k bytes)
    and the base address multiples of 16. Patch 3 at D = 172 (516) and
    patch 1 (172) are copied to padded rows; patch 2 (344) and 64 are read
    in place."""
    assert pp.tma_accepts(k, address) is want


@pytest.mark.parametrize("k,offset,copied", [(344, 0, False), (172, 0, True), (21, 0, True),
                                             (48, 1, True), (48, 8, False)])
def test_tma_rows_pads_what_tma_refuses(k, offset, copied):
    """x as the bf16 forward's tensor map reads it: in place where TMA
    takes its rows, else a copy whose row stride is a multiple of 8 values
    and whose first k values of each row are x's."""
    rows = 5
    base = torch.arange(rows * k + 16, dtype=torch.float32).to(BF16)
    assert base.data_ptr() % 16 == 0
    x2 = base[offset : offset + rows * k].view(rows, k)
    xt, ld = pp.tma_rows(x2)
    assert (xt.data_ptr() != x2.data_ptr()) is copied
    assert ld % 8 == 0 and k <= ld < k + 8 and xt.stride() == (ld, 1)
    assert xt.data_ptr() % 16 == 0 and pp.tma_accepts(ld, xt.data_ptr())
    assert torch.equal(xt[:, :k], x2)


def pack_weight_emulated(w, slot_in, slot_out, k_total, n_rows, ld):
    """csrc/wgmma.cuh::pack_weight's index map, in numpy: (n_rows, ld) bf16
    values, W[k, n] at kp = j * slot_out + f for k = j * slot_in + f."""
    out = np.zeros((n_rows, ld), np.float32)
    for kp in range(ld):
        j, f = divmod(kp, slot_out)
        k = j * slot_in + f
        if f < slot_in and k < k_total:
            out[: w.shape[1], kp] = rb(torch.from_numpy(w[k])).numpy()
    return out


@pytest.mark.parametrize("patch,dt_dim,ced", [(4, 6, 9), (1, 100, 50), (3, 16, 60)])
def test_packed_weight_is_the_padded_bf16_transpose(patch, dt_dim, ced):
    """The wgmma forwards' W scratch: ced padded to column tiles of 56, the
    padded K to stages of 64; the time channel's slots padded from Dt to
    16, each value W's rounded to bf16, zeros elsewhere; the patch
    projection's one slot of K values."""
    w = np.random.RandomState(patch).randn(patch * dt_dim, ced).astype(np.float32)
    dt_pad = tc.padded_dt(dt_dim, tc.BF16_DT_STEP)
    n_pad, kp_pad = pp.packed_weight_shape(ced, patch * dt_pad)
    assert n_pad % 56 == 0 and n_pad >= ced > n_pad - 56
    assert kp_pad % WGMMA_STAGE == 0 and kp_pad >= patch * dt_pad > kp_pad - WGMMA_STAGE
    packed = pack_weight_emulated(w, dt_dim, dt_pad, patch * dt_dim, n_pad, kp_pad)
    _, bw = _padded(torch.zeros((1, patch * dt_dim)), rb(torch.from_numpy(w)), patch, dt_dim,
                    tc.BF16_DT_STEP)
    np.testing.assert_array_equal(packed[:ced, : patch * dt_pad], bw.t().numpy())
    assert not packed[ced:].any() and not packed[:, patch * dt_pad :].any()
    k = patch * dt_dim
    n_pad, k_pad = pp.packed_weight_shape(ced, k)
    one_slot = pack_weight_emulated(w, k, k, k, n_pad, k_pad)
    np.testing.assert_array_equal(one_slot[:ced, :k], rb(torch.from_numpy(w)).numpy().T)
    assert not one_slot[ced:].any() and not one_slot[:, k:].any()
