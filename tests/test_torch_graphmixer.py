"""GraphMixer in the port against the JAX package on the CPU.

On the JAX test fixture (features 172 wide; K = 5 tokens, 2 mixer layers,
Dt = 100, time_gap 20, dropout 0), with the JAX seed-0 parameters carried
by ``from_jax_params``:

  * ``sample`` is integer data, or (prefix mode) two reads of the same f32
    ``feat_prefix`` table: bitwise equal to the JAX sampler's, in both
    node-encoder modes;
  * the net's embeddings of a val batch's quad within 1e-5, prefix against
    JAX prefix and gather against JAX gather; the port's prefix against
    its gather only at 1e-5 (the prefix subtraction agrees with the gather
    to ~1e-6, not bit for bit);
  * one ``train_step`` (the dedup triple) against ``jax.grad`` of the JAX
    trainer's loss: the loss within 1e-5, each gradient within 1e-4 of its
    tensor's largest entry; the frozen time encoder has JAX gradient zero
    and no port gradient, and the optimizer leaves it as it was;
  * ``evaluate`` under random negatives: probabilities and losses within
    1e-5;
  * the fixture fit above the JAX floor (test AP > 0.75,
    ``tests/test_graphmixer.py``), marked slow as the JAX one is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.models import GraphMixer as JaxGraphMixer
from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer
from dyglib_tpu.train import TrainConfig as JaxConfig
from dyglib_tpu_torch.data import chronological_batches, get_link_prediction_data
from dyglib_tpu_torch.graph.csr import time_keys
from dyglib_tpu_torch.models import GraphMixer
from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig
from tests.torch_parity import (
    assert_grads_match,
    assert_probs_close,
    jax_evaluate,
    jax_grads,
    jax_params,
    port_grads,
    port_trainer,
)

KW = dict(num_neighbors=5, num_layers=2, time_gap=20, dropout=0.0)
MODES = ["prefix", "gather"]
TRAIN_B, LR = 200, 1e-3


@pytest.fixture(scope="module")
def port_data(synthetic_dataset):
    return get_link_prediction_data("synthetic", data_root=synthetic_dataset)


@pytest.fixture(scope="module")
def sides(link_data, port_data, tmp_path_factory):
    """Per mode: the JAX trainer, its seed-0 parameters, the port trainer."""
    out = {}
    for mode in MODES:
        jtr = JaxTrainer(JaxGraphMixer(**KW, node_encoder_mode=mode), link_data,
                         JaxConfig(batch_size=TRAIN_B, learning_rate=LR),
                         str(tmp_path_factory.mktemp("jax") / "gm.pkl"))
        params = jax_params(jtr)
        tr = port_trainer(GraphMixer(**KW, node_encoder_mode=mode), port_data, params,
                          batch_size=TRAIN_B, learning_rate=LR)
        assert (tr.full_csr.feat_prefix is not None) == (mode == "prefix")
        out[mode] = (jtr, params, tr)
    return out


def _quad(port_data):
    b = next(iter(chronological_batches(port_data.val, TRAIN_B)))
    rng = np.random.RandomState(0)
    neg = rng.choice(np.unique(port_data.full.dst), size=(2, len(b.src)))
    ids = np.concatenate([b.src, b.dst, neg[0], neg[1]]).astype(np.int32)
    ts = np.tile(time_keys(b.ts), 4).astype(np.int32)
    return ids, ts


@pytest.mark.parametrize("mode", MODES)
def test_sample_and_net_match_jax(sides, port_data, mode):
    jtr, params, tr = sides[mode]
    ids, ts = _quad(port_data)
    jin = jtr.backbone.sample(jtr.full_csr, jnp.asarray(ids), jnp.asarray(ts), None)
    tin = tr.backbone.sample(tr.full_csr, torch.from_numpy(ids), torch.from_numpy(ts))
    for f in tin._fields:
        a, b = getattr(tin, f), getattr(jin, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    want = jtr.backbone.apply(jax.tree_util.tree_map(jnp.asarray, params["backbone"]),
                              jtr.tables, jin)
    with torch.no_grad():
        got = tr.model(tr.tables, tin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_prefix_agrees_with_gather(sides, port_data):
    ids, ts = (torch.from_numpy(a) for a in _quad(port_data))
    embs = {}
    for mode in MODES:
        _, _, tr = sides[mode]
        with torch.no_grad():
            embs[mode] = tr.model(tr.tables, tr.backbone.sample(tr.full_csr, ids, ts))
    np.testing.assert_allclose(embs["prefix"].numpy(), embs["gather"].numpy(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="prefix"):
        GraphMixer(**KW, node_encoder_mode="prefix").sample(sides["gather"][2].full_csr, ids, ts)


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_jax_grad(sides, port_data, mode):
    jtr, params, _ = sides[mode]
    b = list(chronological_batches(port_data.train, TRAIN_B))[2]
    neg = np.random.RandomState(5).choice(np.unique(port_data.train.dst), size=len(b.src))
    jarrays = jtr._batch_arrays(b, b.src, neg)

    def loss_fn(p):
        return jtr._forward(p, jtr.train_csr, jtr.tables, jarrays, jax.random.PRNGKey(0), True,
                            None, False, None)[0]

    jloss, grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, params))
    tr = port_trainer(GraphMixer(**KW, node_encoder_mode=mode), port_data, params,
                      batch_size=TRAIN_B, learning_rate=LR)
    w_before = tr.model.time_encoder.w.clone()
    loss, _ = tr.train_step(tr._batch_arrays(b, b.src, neg))
    assert tr._layout() == "dedup"
    assert abs(float(loss) - float(jloss)) < 1e-5
    assert_grads_match(port_grads(tr), jax_grads(grads), unreached=("time_encoder.",))
    assert torch.equal(tr.model.time_encoder.w, w_before)


def test_evaluate_matches_jax(sides, link_data, port_data):
    jtr, params, tr = sides["prefix"]
    jlosses, _, jprobs, _ = jax_evaluate(jtr, params, link_data.val, jtr.val_neg)
    losses, _, probs = tr.evaluate(port_data.val, tr.val_neg)
    assert_probs_close(probs, jprobs)
    np.testing.assert_allclose(losses, jlosses, atol=1e-5)


@pytest.mark.slow
def test_fixture_fit_clears_the_jax_floor(port_data, tmp_path):
    tr = LinkPredictionTrainer(
        GraphMixer(num_neighbors=10, num_layers=2, time_gap=200), port_data,
        TrainConfig(batch_size=200, num_epochs=3, patience=5, learning_rate=1e-3),
        save_path=str(tmp_path / "gm.pkl"), device="cpu")
    res = tr.fit(seed=0, log=lambda *a: None)
    assert res["test metrics"]["average_precision"] > 0.75
