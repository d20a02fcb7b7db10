"""TGAT's four attention kernels in the port (dyglib_tpu_torch/ops) against
the JAX package on the CPU, and the port's TemporalMultiHeadAttention
against the JAX module.

On the CPU each wrapper takes its plain PyTorch version, so these tests
hold the plain versions to the JAX functions: the ``*_reference`` oracles
of the gathered, window and Phi kernels, and ``temporal_attention`` (which
has no oracle) in Pallas interpret mode at M <= 8. The CUDA kernels are
held to the plain versions on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py). The attention forwards' CUDA math, reassociated so that no
kv row is projected (csrc/attention_core.cuh), is written out here in torch
and held to the JAX f32 path of each of the three kernels.

Tolerances:
  * bf16 mode (projection operands rounded to bf16, f32 accumulation, the
    TPU kernels' math): atol 2e-4, the JAX package's own kernel-vs-oracle
    tolerance (tests/test_gathered_attention.py); both sides round the same
    operands and differ in the f32 summation order (and in the last ulp of
    cos, which can flip a rare bf16 rounding);
  * f32 mode against the same math in JAX f32 (HIGHEST precision): atol
    1e-5, for sums of <= 32 products of O(1) values and a softmax;
  * the module against the JAX module's plain f32 path: atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.nn.modules import TemporalMultiHeadAttention as JaxMHA
from dyglib_tpu.ops.pallas.gathered_attention import gathered_attention_reference
from dyglib_tpu.ops.pallas.phi_projection import phi_projection_reference
from dyglib_tpu.ops.pallas.temporal_attention import temporal_attention as jax_temporal_attention
from dyglib_tpu.ops.pallas.window_attention import window_attention_reference
from dyglib_tpu_torch import ops
from dyglib_tpu_torch.nn import TemporalMultiHeadAttention
from dyglib_tpu_torch.transfer import module_state_dict

H = 2
HIGHEST = jax.lax.Precision.HIGHEST


def _case(seed, m, k=5, dn=12, de=12, dt_dim=10, dq=16, t_rows=60):
    """Random operands of all four kernels, as numpy arrays; row 3 (when
    m > 3) is all padding."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mask = (rng.rand(m, k) > 0.3).astype(np.float32)
    if m > 3:
        mask[3] = 0.0
    return dict(
        q3=f(m, dq), nbr=f(m, k, dn), edge=f(m, k, de), phi=f(m, k, dt_dim),
        dt=np.floor(rng.rand(m, k) * 1e4).astype(np.float32), mask=mask,
        keep=((rng.rand(m, H, k) > 0.1) / 0.9).astype(np.float32),
        tw=(1.0 / 10 ** np.linspace(0, 4, dt_dim)).astype(np.float32), tb=f(dt_dim) * 0.1,
        wk=f(dn + de + dt_dim, dq) * 0.2, wv=f(dn + de + dt_dim, dq) * 0.2,
        table=f(t_rows, dn + de), starts=rng.randint(0, t_rows - k + 1, m).astype(np.int32),
    )


def _t(c):
    return {name: torch.from_numpy(a) for name, a in c.items()}


def _j(c):
    return {name: jnp.asarray(a) for name, a in c.items()}


def _jax_attend_f32(q3, kv, mask, keep, wk, wv):
    """The attention math of the JAX oracles in f32 (no bf16 rounding)."""
    m, k = mask.shape
    dq = q3.shape[-1]
    hd = dq // H
    key = jnp.dot(kv, wk, precision=HIGHEST).reshape(m, k, dq)
    val = jnp.dot(kv, wv, precision=HIGHEST).reshape(m, k, dq)
    outs, scores = [], []
    for h in range(H):
        sl = slice(h * hd, (h + 1) * hd)
        lh = (q3[:, None, sl] * key[..., sl]).sum(-1) * hd**-0.5
        sh = jax.nn.softmax(jnp.where(mask > 0, lh, -1e10), axis=-1) * keep[:, h, :]
        outs.append((sh[:, :, None] * val[..., sl]).sum(1))
        scores.append(sh)
    return jnp.concatenate(outs, axis=-1), jnp.stack(scores, axis=1)


def _phi(c):
    return jnp.cos(c["dt"][..., None] * c["tw"] + c["tb"])


# M = 9 (one block of the CUDA kernels, an all-padded row), M = 2 (less than
# one block), M = 70 (more queries than one 64-row tile holds)
SIZES = [(0, 9), (1, 2), (2, 70)]


# ---- kernel 5: temporal attention
@pytest.mark.parametrize("seed,m", [(0, 8), (1, 2)])
def test_temporal_attention_plain_bf16_matches_jax_kernel(seed, m):
    c = _case(seed, m)
    t, j = _t(c), _j(c)
    args = ("q3", "nbr", "edge", "phi", "mask", "keep", "wk", "wv")
    out, scores = ops.temporal_attention_plain(*(t[a] for a in args), H,
                                               compute_dtype=torch.bfloat16)
    ref_out, ref_scores = jax_temporal_attention(*(j[a] for a in args), H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), atol=2e-4)


@pytest.mark.parametrize("seed,m", SIZES)
def test_temporal_attention_plain_f32_matches_jax(seed, m):
    c = _case(seed, m)
    t, j = _t(c), _j(c)
    out, scores = ops.temporal_attention_plain(
        t["q3"], t["nbr"], t["edge"], t["phi"], t["mask"], t["keep"], t["wk"], t["wv"], H
    )
    kv = jnp.concatenate([j["nbr"], j["edge"], j["phi"]], -1).reshape(m * 5, -1)
    ref_out, ref_scores = _jax_attend_f32(j["q3"], kv, j["mask"], j["keep"], j["wk"], j["wv"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), atol=1e-5)
    if m > 3:  # all padded: uniform attention over the kept positions, finite
        np.testing.assert_allclose(scores[3].numpy(), c["keep"][3] / 5, atol=1e-7)


# ---- kernel 6: gathered attention
def _gathered_args(c, m, k=5):
    return (c["q3"], c["nbr"].reshape(m * k, -1), c["edge"].reshape(m * k, -1), c["dt"],
            c["mask"], c["keep"], (c["tw"], c["tb"]), (c["wk"], c["wv"]), H)


@pytest.mark.parametrize("seed,m", SIZES)
def test_gathered_attention_plain_bf16_matches_oracle(seed, m):
    c = _case(seed, m)
    out = ops.gathered_attention_plain(*_gathered_args(_t(c), m), compute_dtype=torch.bfloat16)
    ref = gathered_attention_reference(*_gathered_args(_j(c), m))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("seed,m", SIZES)
def test_gathered_attention_plain_f32_matches_jax(seed, m):
    c = _case(seed, m)
    j = _j(c)
    out = ops.gathered_attention_plain(*_gathered_args(_t(c), m))
    kv = jnp.concatenate([j["nbr"], j["edge"], _phi(j)], -1).reshape(m * 5, -1)
    ref, _ = _jax_attend_f32(j["q3"], kv, j["mask"], j["keep"], j["wk"], j["wv"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


# ---- kernel 7: window attention
def _window_args(c):
    return (c["q3"], c["starts"], c["dt"], c["mask"], c["keep"], c["table"], c["tw"], c["tb"],
            (c["wk"], c["wv"]), H)


@pytest.mark.parametrize("seed,m", SIZES)
def test_window_attention_plain_bf16_matches_oracle(seed, m):
    c = _case(seed, m)
    out = ops.window_attention_plain(*_window_args(_t(c)), compute_dtype=torch.bfloat16)
    ref = window_attention_reference(*_window_args(_j(c)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("seed,m", SIZES)
def test_window_attention_plain_f32_matches_jax(seed, m):
    c = _case(seed, m)
    j = _j(c)
    out = ops.window_attention_plain(*_window_args(_t(c)))
    win = j["table"][j["starts"][:, None] + jnp.arange(5)] * j["mask"][..., None]
    kv = jnp.concatenate([win, _phi(j)], -1).reshape(m * 5, -1)
    ref, _ = _jax_attend_f32(j["q3"], kv, j["mask"], j["keep"], j["wk"], j["wv"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_window_attention_equals_gathered_on_the_same_rows():
    """The window path's kv rows are the table's rows times the mask: fed
    those rows as slabs, the gathered path gives the same output."""
    m, k = 9, 5
    c = _case(3, m)
    t = _t(c)
    rows = t["table"][t["starts"].long()[:, None] + torch.arange(k)] * t["mask"][..., None]
    dn = c["nbr"].shape[-1]
    gathered = ops.gathered_attention_plain(
        t["q3"], rows[..., :dn].reshape(m * k, -1), rows[..., dn:].reshape(m * k, -1), t["dt"],
        t["mask"], t["keep"], (t["tw"], t["tb"]), (t["wk"], t["wv"]), H,
    )
    torch.testing.assert_close(ops.window_attention_plain(*_window_args(t)), gathered,
                               atol=1e-6, rtol=0)


# ---- the reassociated forward of kernels 5-7, as the CUDA kernels compute it
def _reassociated_forward(q3, kv, mask, keep, wk, wv):
    """qk = Wk_h q3_h, logits kv . qk, w = softmax * keep, Av = sum_j w kv_j,
    out_h = Av Wv_h; kv (M * K, Dkv) -> (out (M, Dq), scores (M, H, K))."""
    m, k = mask.shape
    dq = q3.shape[-1]
    hd = dq // H
    kv = kv.reshape(m, k, -1)
    qk = torch.einsum("mhd,chd->mhc", q3.view(m, H, hd), wk.reshape(-1, H, hd))
    logits = torch.einsum("mkc,mhc->mhk", kv, qk) * hd**-0.5
    w = torch.softmax(torch.where(mask[:, None, :] > 0, logits, -1e10), dim=-1) * keep
    av = torch.einsum("mhk,mkc->mhc", w, kv)
    out = torch.einsum("mhc,chd->mhd", av, wv.reshape(-1, H, hd)).reshape(m, dq)
    return out, w


def _kv_rows(kernel, c, lib):
    """The kv rows (M * K, Dkv) kernel 5, 6 or 7 attends over, built with
    ``lib`` (torch or jax.numpy) from the case's arrays."""
    m, k = c["mask"].shape
    phi = lib.cos(c["dt"][..., None] * c["tw"] + c["tb"])
    if kernel == "temporal":
        parts = [c["nbr"], c["edge"], c["phi"]]
    elif kernel == "gathered":
        parts = [c["nbr"], c["edge"], phi]
    else:
        rows = np.asarray(c["starts"], dtype=np.int64)[:, None] + np.arange(k)
        parts = [c["table"][rows] * c["mask"][..., None], phi]
    return lib.concatenate(parts, -1).reshape(m * k, -1)


# (seed, M, K): an all-padded query (row 3) in each; M = 70 is not a
# multiple of the 64-row tiles of the per-head products; K = 1; K = 20
REASSOCIATED_CASES = [(0, 9, 5), (1, 70, 5), (2, 6, 1), (3, 5, 20)]


@pytest.mark.parametrize("seed,m,k", REASSOCIATED_CASES)
@pytest.mark.parametrize("kernel", ["temporal", "gathered", "window"])
def test_reassociated_forward_matches_jax_f32(kernel, seed, m, k):
    c = _case(seed, m, k=k)
    c["keep"][1, 0, :] = 0.0  # one head of one query dropped entirely
    t, j = _t(c), _j(c)
    kv = _kv_rows(kernel, t, torch)
    out, scores = _reassociated_forward(t["q3"], kv, t["mask"], t["keep"], t["wk"], t["wv"])
    ref_out, ref_scores = _jax_attend_f32(j["q3"], _kv_rows(kernel, j, jnp), j["mask"], j["keep"],
                                          j["wk"], j["wv"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
    if kernel == "temporal":  # kernel 5 returns the scores
        np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), atol=1e-5)
    if m > 3:  # all padded: uniform attention over the kept positions, finite
        np.testing.assert_allclose(scores[3].numpy(), c["keep"][3] / k, atol=1e-7)
    assert not scores[1, 0].any() and torch.isfinite(out).all()


def test_attention_checks_refuse_k_only_by_shared_memory():
    """The wrappers' check takes any K whose rows fit one block's shared
    memory (K = 96 here), and names that limit when they do not, for the
    forward and the backward."""
    from dyglib_tpu_torch.ops import _attention

    def operands(m, k, dq=16):
        return (torch.zeros(m, dq), torch.ones(m, k), torch.ones(m, H, k))

    q3, mask, keep = operands(3, 96)
    wk = torch.zeros(34, 16)
    assert _attention.check_attention(q3, mask, keep, wk, wk, 34, H)[:3] == (3, 96, 16)
    _attention.backward_scratch(3, 96, 34, 16, H, "cpu")
    q3, mask, keep = operands(2, 600)
    wk = torch.zeros(100, 16)  # 600 rows of 100 floats: 240,000 bytes
    with pytest.raises(ValueError, match="shared memory in the forward kernel"):
        _attention.check_attention(q3, mask, keep, wk, wk, 100, H)
    with pytest.raises(ValueError, match="shared memory in the backward kernel"):
        _attention.backward_scratch(2, 560, 100, 16, H, "cpu")


# (M, Dkv, Dq, heads): TGAT's layer 1 at hop 1 and hop 0, Dkv 443, ragged
# small widths, one and four heads, 240,000 queries
HEAD_PLAN_CASES = [(12_000, 444, 272, 2), (600, 444, 272, 2), (333, 443, 272, 2), (37, 26, 30, 3),
                   (5, 16, 16, 4), (1, 444, 272, 1), (240_000, 444, 272, 4)]


@pytest.mark.parametrize("m,kv_dim,dq,heads", HEAD_PLAN_CASES)
def test_head_plan_is_a_function_of_the_shapes_and_cuts_whole_stages(m, kv_dim, dq, heads):
    """The per-head products' plan (``ops/_plan.py::head_plan``) depends on
    the shapes and the SM count alone: planned afresh it is the same, and a
    CPU caller's is an H100's. Every block's rows are one of HEAD_TILE_MS,
    the forward's head_combine rows are the backward's, the weight
    gradient's rows tile Dkv with the least padding, and its chunks are
    whole TILE_K-deep stages, at least HEAD_MIN_CHUNK rows, at most 65535
    with the heads (its grid's z)."""
    from dyglib_tpu_torch.ops import _attention, _plan

    plan = _plan.head_plan(m, kv_dim, dq, heads, _plan.H100_SMS, backward=True)
    forward = _plan.head_plan(m, kv_dim, dq, heads, _plan.H100_SMS, backward=False)
    _plan.head_plan.cache_clear()
    assert _plan.head_plan(m, kv_dim, dq, heads, _plan.H100_SMS, backward=True) == plan
    assert _attention.forward_plan(m, kv_dim, dq, heads, "cpu") == forward
    assert _attention.backward_scratch(m, 1, kv_dim, dq, heads, "cpu")[2] == plan
    project, combine, grad, chunk = plan
    assert {project, combine, grad, forward[0]} <= set(_plan.HEAD_TILE_MS)
    assert forward[1] == combine
    padded = lambda t: -(-kv_dim // t) * t
    assert padded(grad) == min(padded(t) for t in _plan.HEAD_TILE_MS)
    assert chunk % _plan.TILE_K == 0 and chunk >= _plan.HEAD_MIN_CHUNK
    assert -(-m // chunk) * heads <= 65535


def test_head_plan_at_tgat_hops_fills_the_card_in_whole_rounds():
    """At TGAT's hop 1 (M = 12,000) head_project takes 128-row blocks
    (1,504 of them forward, 3,008 backward: 5.7 and 11.4 rounds of the
    card's 264 block slots) and head_combine 64 (752 blocks, 2.85 rounds,
    where 376 of 128 rows would run a second round 42% full); at hop 0
    (M = 600) the forward's head_project takes 64 (80 blocks of 128 rows
    would leave 52 of 132 SMs without one) and head_combine 32; the weight
    gradient's 64-row blocks tile Dkv 444 in 448 rows, and its 19 chunks of
    640 rows (hop 1) give the block slots two rounds."""
    from dyglib_tpu_torch.ops import _plan

    sms = _plan.H100_SMS
    assert _plan.head_plan(12_000, 444, 272, 2, sms, backward=False) == (128, 64)
    assert _plan.head_plan(12_000, 444, 272, 2, sms, backward=True) == (128, 64, 64, 640)
    assert _plan.head_plan(600, 444, 272, 2, sms, backward=False) == (64, 32)
    assert _plan.head_plan(600, 444, 272, 2, sms, backward=True) == (128, 32, 64, 128)


# ---- kernel 8: Phi projection
@pytest.mark.parametrize("seed,r", [(0, 7), (1, 100)])
def test_phi_projection_plain_matches_jax(seed, r):
    rng = np.random.RandomState(seed)
    dt = np.floor(rng.rand(r) * 1e6).astype(np.float32)
    tw = (1.0 / 10 ** np.linspace(0, 9, 10)).astype(np.float32)
    tb = (rng.randn(10) * 0.1).astype(np.float32)
    w = (rng.randn(10, 16) * 0.3).astype(np.float32)
    ours_bf16 = ops.phi_projection_plain(*map(torch.from_numpy, (dt, tw, tb, w)),
                                         compute_dtype=torch.bfloat16)
    ref_bf16 = phi_projection_reference(*map(jnp.asarray, (dt, tw, tb, w)))
    np.testing.assert_allclose(ours_bf16.numpy(), np.asarray(ref_bf16), atol=2e-4)
    ours = ops.phi_projection_plain(*map(torch.from_numpy, (dt, tw, tb, w)))
    ref = jnp.dot(jnp.cos(jnp.asarray(dt)[:, None] * tw + tb), w, precision=HIGHEST)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


# ---- the wrappers on CPU tensors
def test_cpu_wrappers_run_the_plain_versions_and_keep_gradients():
    """On CPU tensors every wrapper returns its plain version's result,
    launches nothing, and stays differentiable (the CUDA wrappers refuse
    grad mode instead: tests/test_torch_cuda_kernels.py)."""
    m = 9
    t = _t(_case(4, m))
    for name in ("q3", "wk", "wv", "tw", "tb"):
        t[name].requires_grad_(True)
    before = ops.launch_counts()
    pairs = [
        (ops.temporal_attention(t["q3"], t["nbr"], t["edge"], t["phi"], t["mask"], t["keep"],
                                t["wk"], t["wv"], H),
         ops.temporal_attention_plain(t["q3"], t["nbr"], t["edge"], t["phi"], t["mask"],
                                      t["keep"], t["wk"], t["wv"], H)),
        (ops.gathered_attention(*_gathered_args(t, m)),
         ops.gathered_attention_plain(*_gathered_args(t, m))),
        (ops.window_attention(*_window_args(t)), ops.window_attention_plain(*_window_args(t))),
        (ops.phi_projection(t["dt"], t["tw"], t["tb"], t["wk"][-10:]),
         ops.phi_projection_plain(t["dt"], t["tw"], t["tb"], t["wk"][-10:])),
    ]
    assert ops.launch_counts() == before
    total = 0.0
    for got, want in pairs:
        got, want = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
        assert torch.equal(got, want)
        total = total + got.square().sum()
    total.backward()
    for name in ("q3", "wk", "wv", "tw", "tb"):
        g = t[name].grad
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0, name


# ---- the module
DN, DE, DT, K = 12, 12, 10, 5


def _module_inputs(seed, m=9):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mask = rng.rand(m, K) > 0.3
    mask[0] = False  # all padded
    mask[1] = True
    return dict(node=f(m, DN), node_t=f(m, DT), nbr=f(m, K, DN), nbr_t=f(m, K, DT),
                edge=f(m, K, DE), mask=mask, dt=np.floor(rng.rand(m, K) * 1e5).astype(np.float32),
                tw=(1.0 / 10 ** np.linspace(0, 9, DT)).astype(np.float32).reshape(1, DT),
                tb=(rng.randn(DT) * 0.1).astype(np.float32),
                table=f(40, DN + DE), starts=rng.randint(0, 40 - K + 1, m).astype(np.int32))


@pytest.mark.parametrize("branch", ["plain", "fused", "gathered", "window", "time_fused"])
def test_module_branches_match_jax_plain_path(branch):
    """Every branch of the port's module, with the JAX module's parameters,
    equals the JAX module's plain f32 path on the same kv rows."""
    x = _module_inputs(5)
    t = {k_: torch.from_numpy(v) for k_, v in x.items()}
    m = x["node"].shape[0]
    nbr, edge = x["nbr"], x["edge"]
    if branch == "window":  # the kv rows the window holds, zeroed at pads
        rows = x["table"][x["starts"][:, None] + np.arange(K)] * x["mask"][..., None]
        nbr, edge = rows[..., :DN], rows[..., DN:]
    phi = np.cos(x["dt"][..., None] * x["tw"][0] + x["tb"]).astype(np.float32)
    jargs = tuple(jnp.asarray(a) for a in (x["node"], x["node_t"], nbr, phi, edge, x["mask"]))
    jmod = JaxMHA(num_heads=H, dropout=0.1)
    params = jmod.init(jax.random.PRNGKey(2), *jargs)
    ref_out, ref_scores = jmod.apply(params, *jargs, train=False)

    mod = TemporalMultiHeadAttention(DN, DE, DT, H, 0.1, torch.Generator().manual_seed(0),
                                     use_pallas=branch == "fused").eval()
    mod.load_state_dict(module_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    tw, tb = t["tw"], t["tb"]
    nbr_t, edge_t = torch.from_numpy(nbr), torch.from_numpy(edge)
    phi_t = torch.from_numpy(phi)
    dt = torch.from_numpy(x["dt"])
    common = (t["node"], t["node_t"])
    with torch.no_grad():
        if branch in ("plain", "fused"):
            out, scores = mod(*common, nbr_t, phi_t, edge_t, t["mask"])
        elif branch == "gathered":
            out, scores = mod(*common, None, None, None, t["mask"],
                              gathered=(nbr_t.reshape(m * K, DN), edge_t.reshape(m * K, DE),
                                        dt, (tw, tb)))
        elif branch == "window":
            out, scores = mod(*common, None, None, None, t["mask"],
                              window=(t["starts"], dt, t["table"], (tw, tb)))
        else:
            out, scores = mod(*common, nbr_t, None, edge_t, t["mask"], time_fused=(dt, (tw, tb)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
    if scores is None:
        assert branch in ("gathered", "window")
    else:
        np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), atol=1e-5)
