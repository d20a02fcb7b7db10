"""The port's post-LN TransformerEncoder and frozen TimeEncoder against the
JAX package's on the CPU.

The JAX module's parameters (xavier q/k/v with zero bias, zero-bias
out_proj, ReLU FFN x4, norm1/norm2) are carried over by
``transfer.module_state_dict``; self-attention, and cross-attention with
separate query, key and value inputs whose padded keys take the -1e10
logit (one row fully padded), agree within 1e-5 (f32 on both sides, sums
in other orders). The gradients of one loss agree within 1e-4 of each
tensor's largest entry; ``k_proj``'s bias, whose gradient is zero in exact
arithmetic (a softmax ignores a shift shared by its logits), holds rounding
noise on both sides and is held to 1e-4 of the largest gradient entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.nn.modules import TimeEncoder as JaxTimeEncoder
from dyglib_tpu.nn.modules import TransformerEncoder as JaxEncoder
from dyglib_tpu_torch.nn import TimeEncoder, TransformerEncoder
from dyglib_tpu_torch.transfer import module_state_dict

B, TQ, TK, D, HEADS = 5, 4, 7, 24, 3


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, TQ, D).astype(np.float32)
    k = rng.randn(B, TK, D).astype(np.float32)
    v = rng.randn(B, TK, D).astype(np.float32)
    mask = rng.rand(B, TK) < 0.6
    mask[:, 0] = True
    mask[2] = False  # a row with every key padded attends uniformly
    return q, k, v, mask


def _pair(dropout=0.1):
    jax_mod = JaxEncoder(D, HEADS, dropout)
    q, k, v, mask = _inputs()
    params = jax_mod.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(k),
                          jnp.asarray(v), jnp.asarray(mask))
    ours = TransformerEncoder(D, HEADS, dropout, torch.Generator().manual_seed(0)).eval()
    ours.load_state_dict(module_state_dict(params))
    return jax_mod, params, ours


def test_state_dict_names_and_init_match_jax():
    _, params, ours = _pair()
    ref = module_state_dict(params)
    fresh = TransformerEncoder(D, HEADS, 0.1, torch.Generator().manual_seed(1)).state_dict()
    assert set(fresh) == set(ref)
    for name, t in fresh.items():
        assert t.shape == ref[name].shape, name
    for name in ("q_proj.bias", "k_proj.bias", "v_proj.bias", "out_proj.bias"):
        assert not fresh[name].any(), name
    bound = (6.0 / (D + D)) ** 0.5  # xavier
    assert float(fresh["q_proj.weight"].abs().max()) <= bound


@pytest.mark.parametrize("mode", ["self", "cross"])
def test_forward_matches_jax(mode):
    jax_mod, params, ours = _pair()
    q, k, v, mask = _inputs(1)
    if mode == "self":
        q = q[:, :TK] if TQ >= TK else np.concatenate([q, k[:, TQ:]], axis=1)
        want = jax_mod.apply(params, jnp.asarray(q), neighbor_mask=jnp.asarray(mask))
        got = ours(torch.from_numpy(q), mask=torch.from_numpy(mask))
    else:
        want = jax_mod.apply(params, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask))
        got = ours(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                   torch.from_numpy(mask))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_gradients_match_jax():
    jax_mod, params, ours = _pair()
    q, k, v, mask = _inputs(2)
    w = np.random.RandomState(3).randn(B, TQ, D).astype(np.float32)

    def loss(p):
        out = jax_mod.apply(p, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
        return (out * jnp.asarray(w)).sum()

    want = module_state_dict(jax.grad(loss)(params))
    out = ours(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               torch.from_numpy(mask))
    (out * torch.from_numpy(w)).sum().backward()
    net_scale = max(float(g.abs().max()) for g in want.values())
    for name, p in ours.named_parameters():
        ref = want[name].numpy()
        err = float(np.abs(p.grad.numpy() - ref).max())
        scale = net_scale if name == "k_proj.bias" else float(np.abs(ref).max())
        assert err <= 1e-4 * scale, (name, err)


def test_dropout_draws_from_the_generator():
    _, _, ours = _pair(dropout=0.5)
    ours.train()
    q = torch.from_numpy(_inputs()[0])
    with pytest.raises(ValueError, match="Generator"):
        ours(q)
    a = ours(q, dropout_gen=torch.Generator().manual_seed(4))
    b = ours(q, dropout_gen=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    with pytest.raises(ValueError, match="key and value"):
        ours(q, q)


def test_frozen_time_encoder_matches_jax_and_takes_no_gradient():
    """JAX stops the frozen encoder's gradient (zeros in the tree); the
    port's parameters do not require one (None)."""
    dt = np.random.RandomState(5).rand(6, 3).astype(np.float32) * 1e4
    jax_enc = JaxTimeEncoder(8, trainable=False)
    params = jax_enc.init(jax.random.PRNGKey(0), jnp.asarray(dt))
    grads = jax.grad(lambda p: jax_enc.apply(p, jnp.asarray(dt)).sum())(params)
    assert all(not np.asarray(g).any() for g in jax.tree_util.tree_leaves(grads))
    ours = TimeEncoder(8, trainable=False)
    ours.load_state_dict(module_state_dict(params))
    out = ours(torch.from_numpy(dt))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_enc.apply(params, jnp.asarray(dt))),
                               atol=1e-6, rtol=0)
    assert not out.requires_grad
    assert [p.requires_grad for p in ours.parameters()] == [False, False]
    assert all(p.requires_grad for p in TimeEncoder(8).parameters())
