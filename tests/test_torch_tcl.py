"""TCL in the port against the JAX package on the CPU.

On the JAX test fixture (features 172 wide; K = 5, 2 layers, 2 heads,
Dt = 100, dropout 0), with the JAX seed-0 parameters carried by
``from_jax_params``:

  * ``sample`` (target first, edge id 0) bitwise equal to the JAX sampler's;
  * the net's quad-order embeddings within 1e-5 of JAX's, pairing the
    triple [src || dst || neg_dst] (``triple=True``) and the quad;
  * one ``train_step`` under ``recent`` (the triple) against ``jax.grad``
    of the JAX trainer's loss: the loss within 1e-5, each gradient within
    1e-4 of its tensor's largest entry;
  * under ``uniform`` the draws match JAX's only in distribution, so the
    quad's check takes the JAX sampler's inputs and runs the net and the
    head directly: loss and gradients as above; ``train_step`` and
    ``evaluate`` then take the quad (4B rows) and two eval sweeps agree;
  * the fixture fit above the JAX floors (last epoch's mean loss < 0.93 x
    the first and < 0.69, test AP > 0.53, ``tests/test_remaining_models.py``),
    marked slow as the JAX one is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.models import TCL as JaxTCL
from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer
from dyglib_tpu.train import TrainConfig as JaxConfig
from dyglib_tpu_torch.data import chronological_batches, get_link_prediction_data
from dyglib_tpu_torch.graph.csr import time_keys
from dyglib_tpu_torch.models import TCL
from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig
from tests.torch_parity import (
    assert_grads_match,
    jax_grads,
    jax_params,
    port_grads,
    port_trainer,
    quad_head_loss,
    to_torch,
)

KW = dict(num_neighbors=5, num_layers=2, num_heads=2, dropout=0.0)
TRAIN_B, LR = 200, 1e-3


@pytest.fixture(scope="module")
def port_data(synthetic_dataset):
    return get_link_prediction_data("synthetic", data_root=synthetic_dataset)


@pytest.fixture(scope="module")
def sides(link_data, port_data, tmp_path_factory):
    """Per strategy: the JAX trainer, its seed-0 parameters, the port trainer."""
    out = {}
    for strategy in ("recent", "uniform"):
        jtr = JaxTrainer(JaxTCL(**KW, sample_strategy=strategy), link_data,
                         JaxConfig(batch_size=TRAIN_B, learning_rate=LR),
                         str(tmp_path_factory.mktemp("jax") / "tcl.pkl"))
        params = jax_params(jtr)
        tr = port_trainer(TCL(**KW, sample_strategy=strategy), port_data, params,
                          batch_size=TRAIN_B, learning_rate=LR)
        out[strategy] = (jtr, params, tr)
    return out


def _train_batch(port_data, i=2):
    b = list(chronological_batches(port_data.train, TRAIN_B))[i]
    neg = np.random.RandomState(5).choice(np.unique(port_data.train.dst), size=len(b.src))
    return b, neg


@pytest.mark.parametrize("layout", ["triple", "quad"])
def test_net_matches_jax(sides, port_data, layout):
    jtr, params, tr = sides["recent"]
    b = next(iter(chronological_batches(port_data.val, TRAIN_B)))
    negs = np.random.RandomState(1).choice(np.unique(port_data.full.dst), size=(2, len(b.src)))
    cols = [b.src, b.dst] + ([negs[1]] if layout == "triple" else [negs[0], negs[1]])
    ids = np.concatenate(cols).astype(np.int32)
    ts = np.tile(time_keys(b.ts), len(cols)).astype(np.int32)
    jin = jtr.backbone.sample(jtr.full_csr, jnp.asarray(ids), jnp.asarray(ts), None)
    tin = tr.backbone.sample(tr.full_csr, torch.from_numpy(ids), torch.from_numpy(ts))
    for f in tin._fields:
        np.testing.assert_array_equal(getattr(tin, f).numpy(), np.asarray(getattr(jin, f)))
    triple = layout == "triple"
    want = jtr.backbone.apply(jax.tree_util.tree_map(jnp.asarray, params["backbone"]),
                              jtr.tables, jin, triple=triple)
    with torch.no_grad():
        got = tr.model(tr.tables, tin, triple=triple)
    assert got.shape == (4 * len(b.src), port_data.node_raw_features.shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_train_step_matches_jax_grad(sides, port_data):
    jtr, params, _ = sides["recent"]
    b, neg = _train_batch(port_data)
    jarrays = jtr._batch_arrays(b, b.src, neg)

    def loss_fn(p):
        return jtr._forward(p, jtr.train_csr, jtr.tables, jarrays, jax.random.PRNGKey(0), True,
                            None, False, None)[0]

    jloss, grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, params))
    tr = port_trainer(TCL(**KW), port_data, params, batch_size=TRAIN_B, learning_rate=LR)
    assert tr._layout() == "triple" and tr._layout(False) == "quad"
    loss, _ = tr.train_step(tr._batch_arrays(b, b.src, neg))
    assert abs(float(loss) - float(jloss)) < 1e-5
    assert_grads_match(port_grads(tr), jax_grads(grads))


def test_uniform_quad_step_on_jax_draws(sides, port_data):
    """The JAX sampler's quad inputs through both nets and heads."""
    jtr, params, _ = sides["uniform"]
    b, neg = _train_batch(port_data)
    src, dst, neg_src, neg_dst, ts, _, valid = jtr._batch_arrays(b, b.src, neg)
    ids = jnp.concatenate([src, dst, neg_src, neg_dst])
    jin = jtr.backbone.sample(jtr.train_csr, ids, jnp.tile(ts, 4), jax.random.PRNGKey(3))

    def loss_fn(p):
        embs = jtr.backbone.apply(p["backbone"], jtr.tables, jin)
        return quad_head_loss(jtr, p, embs, valid)

    jloss, grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, params))
    tr = port_trainer(TCL(**KW, sample_strategy="uniform"), port_data, params,
                      batch_size=TRAIN_B, learning_rate=LR)
    assert tr._layout() == "quad"
    tr.model.train()
    loss, _ = tr._head_loss(tr.model(tr.tables, to_torch(jin)), to_torch(valid))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    assert_grads_match(port_grads(tr), jax_grads(grads))


def test_uniform_runs_the_quad_in_train_step_and_evaluate(sides, port_data):
    _, _, tr = sides["uniform"]
    b, neg = _train_batch(port_data)
    rows = []
    sample = tr.backbone.sample

    def spy(csr, ids, ts, **kw):
        rows.append(ids.shape[0])
        return sample(csr, ids, ts, **kw)

    tr.backbone.sample = spy
    try:
        loss, _ = tr.train_step(tr._batch_arrays(b, b.src, neg))
        first = tr.evaluate(port_data.val, tr.val_neg)[2]
        second = tr.evaluate(port_data.val, tr.val_neg)[2]
    finally:
        del tr.backbone.sample
    assert np.isfinite(float(loss))
    assert set(rows) == {4 * TRAIN_B}
    for (p1, n1), (p2, n2) in zip(first, second):
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(n1, n2)


@pytest.mark.slow
def test_fixture_fit_clears_the_jax_floors(port_data):
    tr = LinkPredictionTrainer(TCL(num_neighbors=10, num_layers=2), port_data,
                               TrainConfig(batch_size=200, num_epochs=4, learning_rate=1e-3),
                               device="cpu")
    tr.init_params(0)
    losses = [np.mean(tr.train_epoch()[0]) for _ in range(4)]
    assert losses[-1] < 0.93 * losses[0] and losses[-1] < 0.69, losses
    metrics = tr.evaluate(port_data.test, tr.test_neg, 2)[1]
    assert tr.mean_metrics(metrics)["average_precision"] > 0.53
