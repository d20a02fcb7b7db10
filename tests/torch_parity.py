"""Helpers shared by the port's parity tests (not a test module).

They drive the JAX trainer and the port's trainer side by side on the
JAX test fixture: the JAX side's seed-0 parameters are carried into the
port by ``transfer.from_jax_params``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig
from dyglib_tpu_torch.transfer import from_jax_params


def jax_params(jtr, seed=0):
    """Parameters drawn as the JAX trainer's ``init_params`` draws them, as
    numpy; the backbone's init (which samples a few rows first) is jitted,
    which eager CAWN would take ~20 s for."""
    k_backbone, k_head = jax.random.split(jax.random.PRNGKey(seed))
    zeros = jnp.zeros((1, jtr.tables.node_dim))
    params = {"backbone": jax.jit(jtr.backbone.init)(k_backbone, jtr.tables, jtr.train_csr),
              "head": jtr.head.init(k_head, zeros, zeros)}
    return jax.tree_util.tree_map(np.asarray, params)


def port_trainer(backbone, data, params=None, **cfg):
    """A CPU trainer of ``backbone`` holding the JAX ``params``."""
    tr = LinkPredictionTrainer(backbone, data, TrainConfig(**cfg), device="cpu")
    tr.init_params(0)
    if params is not None:
        tr.load_params(from_jax_params(params))
    return tr


def jax_evaluate(jtr, params, stream, sampler, salt=0, state=None):
    """The JAX trainer's ``evaluate`` -> (losses, metrics, per-batch host
    (pos, neg) probabilities, final state)."""
    recorded = []
    batch_metrics = jtr._batch_metrics

    def record(probs, b):
        recorded.append(jtr._host_probs(probs))
        return batch_metrics(probs, b)

    jtr._batch_metrics = record
    try:
        losses, metrics, state = jtr.evaluate(
            jax.tree_util.tree_map(jnp.asarray, params), stream, sampler, salt, state=state,
            scanned=False)
    finally:
        jtr._batch_metrics = batch_metrics
    return losses, metrics, recorded, state


def assert_probs_close(probs, ref, atol=1e-5):
    assert len(probs) == len(ref) > 0
    for (pos, neg), (jpos, jneg) in zip(probs, ref):
        np.testing.assert_allclose(pos, jpos, atol=atol, rtol=0)
        np.testing.assert_allclose(neg, jneg, atol=atol, rtol=0)


def jax_grads(grads) -> dict:
    """A JAX gradient tree -> {"backbone": ..., "head": ...} state dicts."""
    return from_jax_params(jax.tree_util.tree_map(np.asarray, grads))


def port_grads(tr) -> dict:
    return {"backbone": {k: p.grad for k, p in tr.model.named_parameters()},
            "head": {k: p.grad for k, p in tr.head.named_parameters()}}


# a key projection's bias: its gradient is zero in exact arithmetic (a
# softmax ignores a shift shared by its logits), so both sides hold
# rounding noise, held to the net's largest gradient entry instead
ZERO_IN_EXACT_ARITHMETIC = "k_proj.bias"


def assert_grads_match(got: dict, want: dict, rtol=1e-4, unreached=()):
    """Every gradient within ``rtol`` of its JAX tensor's largest entry
    (``ZERO_IN_EXACT_ARITHMETIC`` tensors: of the largest entry of all).
    Parameters named by a prefix in ``unreached`` (frozen, or out of the
    loss's reach) have no port gradient where JAX's is all zero."""
    net_scale = max(float(v.abs().max()) for sd in want.values() for v in sd.values())
    for part in ("backbone", "head"):
        assert set(got[part]) == set(want[part])
        for k, g in got[part].items():
            ref = want[part][k].numpy()
            if k.startswith(tuple(unreached)):
                assert g is None and not ref.any(), k
                continue
            assert g is not None and torch.isfinite(g).all(), k
            scale = float(np.abs(ref).max())
            if k.endswith(ZERO_IN_EXACT_ARITHMETIC):
                scale = net_scale
            assert scale > 0, k
            err = float(np.abs(g.numpy() - ref).max())
            assert err <= rtol * scale, (k, err, scale)


def quad_head_loss(jtr, params, embs, valid):
    """The JAX trainer's loss on quad-order embeddings (its ``_forward``'s
    head and masked BCE)."""
    import optax

    s_e, d_e, ns_e, nd_e = jnp.split(embs, 4, axis=0)
    pos = jtr.head.apply(params["head"], s_e, d_e)[..., 0]
    neg = jtr.head.apply(params["head"], ns_e, nd_e)[..., 0]
    bce = optax.sigmoid_binary_cross_entropy
    loss = (bce(pos, jnp.ones_like(pos)) + bce(neg, jnp.zeros_like(neg))) * valid
    return loss.sum() / jnp.maximum(2.0 * valid.sum(), 1.0)


def to_torch(tree):
    """JAX arrays (nested in tuples / NamedTuples) -> torch tensors."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_torch(x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(to_torch(x) for x in tree)
    return torch.from_numpy(np.array(tree))
