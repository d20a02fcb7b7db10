"""The backward of TGAT's four attention kernels in the port
(dyglib_tpu_torch/ops) against the JAX package on the CPU.

On the CPU each kernel's autograd.Function runs the plain forward and the
explicit plain backward (``*_backward_plain``), the function the card's
backward kernels are held to (tests/test_torch_cuda_kernels.py,
chip_smoke.py). For each kernel these tests hold that plain backward:

  * in bf16 mode (the JAX kernels' operand rounding, f32 accumulation) to
    ``jax.vjp`` of the JAX Pallas function, run in interpret mode as the
    JAX package's own tests run it: its custom_vjp backward is the
    ``_bwd_kernel`` being ported;
  * in f32 to ``jax.vjp`` of the same math in plain JAX f32 (HIGHEST
    precision), with a nonzero cotangent for temporal attention's scores;
  * through the autograd.Function, to autograd of the plain forward;
  * to finite differences (``torch.autograd.gradcheck``, float64).

Cases: m 2-8 queries, K 1-5 neighbors, narrow widths, 2 heads, dropout
keep masks != 1, an all-padded row (m > 3). The op-by-op f32 references
of the gathered and window kernels take the first two cases.

Tolerances, each relative to the gradient tensor's largest entry:
  * bf16 mode: 5e-3, the JAX package's own kernel-vs-oracle gradient
    tolerance (tests/test_gathered_attention.py): both sides round the same
    operands to bf16, but dkey and dval come out of f32 sums taken in
    another order, and one ulp there can flip a bf16 rounding (2**-8);
  * f32 against JAX f32: 1e-5 (sums of <= 40 products of O(1) values and
    a softmax; dtw's terms carry dt <= 1e4 and cancel, and are held to
    the same share of the largest entry);
  * the Function against autograd of the plain forward: 1e-5 (the same
    math in another association);
  * gradcheck: torch's defaults in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.ops.pallas.gathered_attention import gathered_attention as jax_gathered
from dyglib_tpu.ops.pallas.phi_projection import phi_projection as jax_phi_projection
from dyglib_tpu.ops.pallas.temporal_attention import temporal_attention as jax_temporal
from dyglib_tpu.ops.pallas.window_attention import window_attention as jax_window
from dyglib_tpu_torch import ops

H = 2
HIGHEST = jax.lax.Precision.HIGHEST
# (seed, m, k): an all-padded row, K = 1, a full block of small rows
CASES = [(0, 5, 4), (1, 2, 1), (2, 8, 5)]


def _case(seed, m, k, dn=6, de=5, dt_dim=4, dq=8, t_rows=40):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mask = (rng.rand(m, k) > 0.3).astype(np.float32)
    if m > 3:
        mask[3] = 0.0
    kv = dn + de + dt_dim
    return dict(
        q3=f(m, dq), nbr=f(m, k, dn), edge=f(m, k, de), phi=f(m, k, dt_dim),
        dt=np.floor(rng.rand(m, k) * 1e4).astype(np.float32), mask=mask,
        keep=((rng.rand(m, H, k) > 0.2) / 0.8).astype(np.float32),
        tw=(1.0 / 10 ** np.linspace(0, 4, dt_dim)).astype(np.float32), tb=f(dt_dim) * 0.1,
        wk=f(kv, dq) * kv**-0.5, wv=f(kv, dq) * kv**-0.5,
        table=f(t_rows, dn + de), starts=rng.randint(0, t_rows - k + 1, m).astype(np.int32),
        dout=f(m, dq), dscores=f(m, H, k),
    )


def _t(c, dtype=torch.float32):
    return {n: torch.from_numpy(a) if a.dtype == np.int32 else torch.from_numpy(a).to(dtype)
            for n, a in c.items()}


def _j(c):
    return {n: jnp.asarray(a) for n, a in c.items()}


def _rel_close(ours, ref, atol, name=""):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) + 1e-12
    np.testing.assert_allclose(np.asarray(ours) / scale, ref / scale, atol=atol, err_msg=name)


def _jax_attend_f32(q3, kv, mask, keep, wk, wv):
    """The attention math in JAX f32 (no bf16 rounding): (out, scores)."""
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


def _jax_phi(dt, tw, tb):
    return jnp.cos(dt[..., None] * tw + tb)


def _vjp(f, primals, cotangent, jit=True):
    """jax.vjp of f at primals, applied to the cotangent; jitted by default
    (op by op the interpreted Pallas kernels take ~5x longer on the CPU).
    The f32 references that compute Phi run op by op: jitted, XLA fuses
    dt * tw + tb into one rounding, where PyTorch (and the port's kernels)
    round twice, and at dt ~ 1e6 that moves theta by ulp(1e6)."""
    vjp = lambda p, ct: jax.vjp(f, *p)[1](ct)
    return (jax.jit(vjp) if jit else vjp)(tuple(primals), cotangent)


def _assert_grads(ours, ref, atol, names):
    assert len(ours) == len(ref) == len(names)
    for got, want, name in zip(ours, ref, names):
        assert tuple(got.shape) == tuple(np.shape(want)), name
        _rel_close(got.detach().numpy(), want, atol, name)


# ---- kernel 5: temporal attention
TA_NAMES = ("dq3", "dnbr", "dedge", "dphi", "dwk", "dwv")
TA_ARGS = ("q3", "nbr", "edge", "phi", "mask", "keep", "wk", "wv")


@pytest.mark.parametrize("seed,m,k", CASES)
def test_temporal_attention_backward_bf16_matches_jax_kernel(seed, m, k):
    c = _case(seed, m, k)
    t, j = _t(c), _j(c)
    f = lambda q3, nbr, edge, phi, wk, wv: jax_temporal(q3, nbr, edge, phi, j["mask"],
                                                        j["keep"], wk, wv, H)
    ref = _vjp(f, (j[a] for a in ("q3", "nbr", "edge", "phi", "wk", "wv")),
               (j["dout"], j["dscores"]))
    ours = ops.temporal_attention_backward_plain(
        *(t[a] for a in TA_ARGS), t["dout"], t["dscores"], H, compute_dtype=torch.bfloat16
    )
    _assert_grads(ours, ref, 5e-3, TA_NAMES)


@pytest.mark.parametrize("seed,m,k", CASES)
def test_temporal_attention_backward_f32_matches_jax(seed, m, k):
    c = _case(seed, m, k)
    t, j = _t(c), _j(c)

    def f(q3, nbr, edge, phi, wk, wv):
        kv = jnp.concatenate([nbr, edge, phi], -1).reshape(m * k, -1)
        return _jax_attend_f32(q3, kv, j["mask"], j["keep"], wk, wv)

    ref = _vjp(f, (j[a] for a in ("q3", "nbr", "edge", "phi", "wk", "wv")),
               (j["dout"], j["dscores"]))
    ours = ops.temporal_attention_backward_plain(*(t[a] for a in TA_ARGS), t["dout"],
                                                 t["dscores"], H)
    _assert_grads(ours, ref, 1e-5, TA_NAMES)
    # no scores cotangent: the same as a zero one
    none = ops.temporal_attention_backward_plain(*(t[a] for a in TA_ARGS), t["dout"], None, H)
    zero = ops.temporal_attention_backward_plain(*(t[a] for a in TA_ARGS), t["dout"],
                                                 torch.zeros_like(t["dscores"]), H)
    for a, b in zip(none, zero):
        assert torch.equal(a, b)


# ---- kernel 6: gathered attention
GA_NAMES = ("dq3", "dtw", "dtb", "dwk", "dwv")


def _gathered(c, m, k):
    return (c["q3"], c["nbr"].reshape(m * k, -1), c["edge"].reshape(m * k, -1), c["dt"],
            c["mask"], c["keep"])


@pytest.mark.parametrize("seed,m,k", CASES)
def test_gathered_attention_backward_bf16_matches_jax_kernel(seed, m, k):
    c = _case(seed, m, k)
    t, j = _t(c), _j(c)
    q3, fn, fe, dt, mask, keep = _gathered(j, m, k)
    f = lambda q3_, tw, tb, wk, wv: jax_gathered(q3_, fn, fe, dt, mask, keep, (tw, tb), (wk, wv), H)
    ref = _vjp(f, (q3, j["tw"], j["tb"], j["wk"], j["wv"]), j["dout"])
    ours = ops.gathered_attention_backward_plain(
        *_gathered(t, m, k), (t["tw"], t["tb"]), (t["wk"], t["wv"]), t["dout"], H,
        compute_dtype=torch.bfloat16,
    )
    _assert_grads(ours, ref, 5e-3, GA_NAMES)


@pytest.mark.parametrize("seed,m,k", CASES[:2])
def test_gathered_attention_backward_f32_matches_jax(seed, m, k):
    c = _case(seed, m, k)
    t, j = _t(c), _j(c)
    _, fn, fe, dt, mask, keep = _gathered(j, m, k)

    def f(q3, tw, tb, wk, wv):
        kv = jnp.concatenate([fn, fe, _jax_phi(dt, tw, tb).reshape(m * k, -1)], -1)
        return _jax_attend_f32(q3, kv, mask, keep, wk, wv)[0]

    ref = _vjp(f, (j["q3"], j["tw"], j["tb"], j["wk"], j["wv"]), j["dout"], jit=False)
    ours = ops.gathered_attention_backward_plain(*_gathered(t, m, k), (t["tw"], t["tb"]),
                                                 (t["wk"], t["wv"]), t["dout"], H)
    _assert_grads(ours, ref, 1e-5, GA_NAMES)


# ---- kernel 7: window attention
def _window(c):
    return c["q3"], c["starts"], c["dt"], c["mask"], c["keep"], c["table"]


@pytest.mark.parametrize("seed,m,k", CASES)
def test_window_attention_backward_bf16_matches_jax_kernel(seed, m, k):
    c = _case(seed, m, k)
    t, j = _t(c), _j(c)
    q3, starts, dt, mask, keep, table = _window(j)
    f = lambda q3_, tw, tb, wk, wv: jax_window(q3_, starts, dt, mask, keep, table, tw, tb,
                                               (wk, wv), H)
    ref = _vjp(f, (q3, j["tw"], j["tb"], j["wk"], j["wv"]), j["dout"])
    ours = ops.window_attention_backward_plain(
        *_window(t), t["tw"], t["tb"], (t["wk"], t["wv"]), t["dout"], H,
        compute_dtype=torch.bfloat16,
    )
    _assert_grads(ours, ref, 5e-3, GA_NAMES)


@pytest.mark.parametrize("seed,m,k", CASES[:2])
def test_window_attention_backward_f32_matches_jax(seed, m, k):
    c = _case(seed, m, k)
    t, j = _t(c), _j(c)
    _, starts, dt, mask, keep, table = _window(j)
    win = table[starts[:, None] + jnp.arange(k)] * mask[..., None]

    def f(q3, tw, tb, wk, wv):
        kv = jnp.concatenate([win, _jax_phi(dt, tw, tb)], -1).reshape(m * k, -1)
        return _jax_attend_f32(q3, kv, mask, keep, wk, wv)[0]

    ref = _vjp(f, (j["q3"], j["tw"], j["tb"], j["wk"], j["wv"]), j["dout"], jit=False)
    ours = ops.window_attention_backward_plain(*_window(t), t["tw"], t["tb"],
                                               (t["wk"], t["wv"]), t["dout"], H)
    _assert_grads(ours, ref, 1e-5, GA_NAMES)


# ---- kernel 8: Phi projection
PHI_CASES = [(0, 7, 4, 8), (1, 40, 10, 6)]


def _phi_case(seed, r, dt_dim, dq):
    rng = np.random.RandomState(seed)
    return dict(
        dt=np.floor(rng.rand(r) * 1e6).astype(np.float32),
        tw=(1.0 / 10 ** np.linspace(0, 9, dt_dim)).astype(np.float32),
        tb=(rng.randn(dt_dim) * 0.1).astype(np.float32),
        w=(rng.randn(dt_dim, dq) * 0.3).astype(np.float32),
        dout=rng.randn(r, dq).astype(np.float32),
    )


@pytest.mark.parametrize("seed,r,dt_dim,dq", PHI_CASES)
def test_phi_projection_backward_matches_jax(seed, r, dt_dim, dq):
    c = _phi_case(seed, r, dt_dim, dq)
    t, j = _t(c), _j(c)
    names = ("dtw", "dtb", "dw")
    params = (j["tw"], j["tb"], j["w"])
    ref = _vjp(lambda tw, tb, w: jax_phi_projection(j["dt"], tw, tb, w), params, j["dout"])
    ours = ops.phi_projection_backward_plain(t["dt"], t["tw"], t["tb"], t["w"], t["dout"],
                                             compute_dtype=torch.bfloat16)
    _assert_grads(ours, ref, 5e-3, names)
    f32 = lambda tw, tb, w: jnp.dot(_jax_phi(j["dt"], tw, tb), w, precision=HIGHEST)
    ours = ops.phi_projection_backward_plain(t["dt"], t["tw"], t["tb"], t["w"], t["dout"])
    _assert_grads(ours, _vjp(f32, params, j["dout"], jit=False), 1e-5, names)


# ---- the autograd.Functions on CPU tensors
def _calls(t, m, k):
    """(Function call, plain forward) of each kernel on the tensors ``t``,
    each a function of the differentiable operands, and those operands."""
    return {
        "temporal_attention": (
            lambda q3, nbr, edge, phi, wk, wv, _f=None: (_f or ops.temporal_attention)(
                q3, nbr, edge, phi, t["mask"], t["keep"], wk, wv, H),
            ops.temporal_attention_plain,
            ("q3", "nbr", "edge", "phi", "wk", "wv"),
        ),
        "gathered_attention": (
            lambda q3, tw, tb, wk, wv, _f=None: (_f or ops.gathered_attention)(
                q3, t["nbr"].reshape(m * k, -1), t["edge"].reshape(m * k, -1), t["dt"],
                t["mask"], t["keep"], (tw, tb), (wk, wv), H),
            ops.gathered_attention_plain,
            ("q3", "tw", "tb", "wk", "wv"),
        ),
        "window_attention": (
            lambda q3, tw, tb, wk, wv, _f=None: (_f or ops.window_attention)(
                q3, t["starts"], t["dt"], t["mask"], t["keep"], t["table"], tw, tb, (wk, wv), H),
            ops.window_attention_plain,
            ("q3", "tw", "tb", "wk", "wv"),
        ),
        "phi_projection": (
            lambda tw, tb, wk, _f=None: (_f or ops.phi_projection)(
                t["dt"].reshape(-1), tw, tb, wk.t().contiguous().t()[-tw.shape[0]:]),
            ops.phi_projection_plain,
            ("tw", "tb", "wk"),
        ),
    }


@pytest.mark.parametrize("kernel", ["temporal_attention", "gathered_attention",
                                    "window_attention", "phi_projection"])
@pytest.mark.parametrize("seed,m,k", CASES[:2])
def test_autograd_function_matches_autograd_of_the_plain_forward(kernel, seed, m, k):
    """The CPU Function (plain forward, explicit plain backward) against
    torch autograd of the plain forward, with the scores' cotangent for
    temporal attention; the Function launches nothing."""
    c = _case(seed, m, k)
    grads = []
    for plain in (False, True):
        t = _t(c)
        call, plain_fn, names = _calls(t, m, k)[kernel]
        leaves = [t[n].requires_grad_(True) for n in names]
        before = ops.launch_counts()
        out = call(*leaves, _f=plain_fn if plain else None)
        assert ops.launch_counts() == before
        if isinstance(out, tuple):
            loss = (out[0] * t["dout"]).sum() + (out[1] * t["dscores"]).sum()
        else:
            loss = (out * torch.from_numpy(np.cos(np.arange(out.numel())).astype(np.float32))
                    .view(out.shape)).sum()
        grads.append(torch.autograd.grad(loss, leaves))
    for name, got, want in zip(names, *grads):
        _rel_close(got.numpy(), want.numpy(), 1e-5, f"{kernel} {name}")


@pytest.mark.parametrize("kernel", ["temporal_attention", "gathered_attention",
                                    "window_attention", "phi_projection"])
def test_autograd_function_gradcheck(kernel):
    """Finite differences through the CPU Function, float64, at an
    all-padded row and dropout keep != 1 (m = 5, K = 3)."""
    m, k = 5, 3
    c = _case(7, m, k, dn=3, de=2, dt_dim=3, dq=4, t_rows=12)
    c["dt"] = np.floor(c["dt"] / 100.0)  # float64 differences at moderate theta
    t = _t(c, torch.float64)
    call, _, names = _calls(t, m, k)[kernel]
    leaves = tuple(t[n].requires_grad_(True) for n in names)
    assert torch.autograd.gradcheck(call, leaves)
