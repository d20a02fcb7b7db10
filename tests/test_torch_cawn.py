"""CAWN in the port against the JAX package on the CPU.

On the JAX test fixture (features 172 wide; walk length L = 1 with K = 4
and L = 2 with K = 3; 2 walk heads, position features 16, Dt = 100,
dropout 0, ``time_interval_aware`` with the trainer's time scaling), with
the JAX seed-0 parameters carried by ``from_jax_params``. The port's draws
match JAX's only in distribution, so every check takes the JAX sampler's
quad inputs (a val batch's [src || dst || neg_src || neg_dst]):

  * the position counts by both of the port's paths (the fused compare,
    and the sorted-key join forced by a zero limit) equal JAX's
    ``walk_position_counts`` exactly, and the walk-granularity join equals
    JAX's ``_walk_position_counts_join``;
  * the net's embeddings within 1e-5 of JAX's;
  * one step through the net and the head: the loss within 1e-5 and each
    gradient within 1e-4 of its tensor's largest entry; the backward
    direction's recurrent weights are never read: JAX's gradient is zero,
    the port's None;
  * the trainer embeds the quad in training and evaluation, and two eval
    sweeps agree (the eval generator is seeded afresh);
  * the fixture fit above the JAX floor (test AP > 0.58,
    ``tests/test_remaining_models.py``), marked slow as the JAX one is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.models import CAWN as JaxCAWN
from dyglib_tpu.models.cawn import _walk_position_counts_join as jax_walk_join
from dyglib_tpu.models.cawn import walk_position_counts as jax_walk_counts
from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer
from dyglib_tpu.train import TrainConfig as JaxConfig
from dyglib_tpu_torch.data import chronological_batches, get_link_prediction_data
from dyglib_tpu_torch.models import CAWN, hop_position_counts, walk_position_counts
from dyglib_tpu_torch.models import cawn as cawn_module
from dyglib_tpu_torch.models import walk_position_counts_join
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

WALKS = {1: 4, 2: 3}  # walk length -> K
KW = dict(num_walk_heads=2, position_feat_dim=16, dropout=0.0)
B, LR = 200, 1e-3
UNREACHED = ("feature_encoder.bwd_wh", "position_encoder.bwd_wh")


@pytest.fixture(scope="module")
def port_data(synthetic_dataset):
    return get_link_prediction_data("synthetic", data_root=synthetic_dataset)


@pytest.fixture(scope="module")
def sides(link_data, port_data, tmp_path_factory):
    """Per walk length: the JAX trainer, its seed-0 parameters, the port
    trainer, and the JAX sampler's inputs and valid mask for the first val
    batch's quad."""
    out = {}
    for walk_length, k in WALKS.items():
        kw = dict(num_neighbors=k, walk_length=walk_length, **KW)
        jtr = JaxTrainer(JaxCAWN(**kw, compute_dtype="float32"), link_data,
                         JaxConfig(batch_size=B, learning_rate=LR),
                         str(tmp_path_factory.mktemp("jax") / "cawn.pkl"))
        params = jax_params(jtr)
        tr = port_trainer(CAWN(**kw), port_data, params, batch_size=B, learning_rate=LR)
        b = next(iter(chronological_batches(link_data.val, B)))
        negs = np.random.RandomState(2).choice(np.unique(link_data.full.dst), size=(2, B))
        src, dst, neg_src, neg_dst, ts, _, valid = jtr._batch_arrays(b, negs[0], negs[1])
        ids = jnp.concatenate([src, dst, neg_src, neg_dst])
        jin = jax.jit(jtr.backbone.sample)(jtr.full_csr, ids, jnp.tile(ts, 4),
                                           jax.random.PRNGKey(11))
        out[walk_length] = (jtr, params, tr, jin, valid)
    return out


@pytest.mark.parametrize("walk_length", sorted(WALKS))
@pytest.mark.parametrize("path", ["fused", "join"])
def test_position_counts_match_jax_oracle(sides, monkeypatch, walk_length, path):
    jtr, _, tr, jin, _ = sides[walk_length]
    n = jtr.tables.node.shape[0]
    want = np.asarray(jax_walk_counts(jin.walk_ids, jin.hop_ids, n))
    tin = to_torch(jin)
    if path == "join":
        monkeypatch.setattr(cawn_module, "FUSED_COUNT_LIMIT", 0)
    got = walk_position_counts(tin.walk_ids, tin.hop_ids, n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and want.shape[-2:] == (2, walk_length + 1)
    hop = hop_position_counts(tin.hop_ids, n)
    assert [h.shape[1] for h in hop] == [WALKS[walk_length] ** st
                                         for st in range(walk_length + 1)]
    np.testing.assert_array_equal(
        walk_position_counts_join(tin.walk_ids, tin.hop_ids, n).numpy(),
        np.asarray(jax_walk_join(jin.walk_ids, jin.hop_ids, n)))


@pytest.mark.parametrize("walk_length", sorted(WALKS))
def test_net_and_one_step_match_jax(sides, walk_length):
    jtr, params, tr, jin, valid = sides[walk_length]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = jax.jit(jtr.backbone.apply)(jp["backbone"], jtr.tables, jin)
    with torch.no_grad():
        got = tr.model(tr.tables, to_torch(jin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)

    def loss_fn(p):
        return quad_head_loss(jtr, p, jtr.backbone.apply(p["backbone"], jtr.tables, jin), valid)

    jloss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    tr.model.train()
    tr.optimizer.zero_grad(set_to_none=True)
    loss, _ = tr._head_loss(tr.model(tr.tables, to_torch(jin)), to_torch(valid))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    assert_grads_match(port_grads(tr), jax_grads(grads), unreached=UNREACHED)


def test_trainer_embeds_the_quad(sides, port_data):
    _, _, tr, _, _ = sides[1]
    assert tr._layout() == tr._layout(False) == "quad"
    assert tr.train_csr.tia_cew is not None and tr.sample_gen is not None
    rows = []
    sample = tr.backbone.sample

    def spy(csr, ids, ts, **kw):
        rows.append(ids.shape[0])
        return sample(csr, ids, ts, **kw)

    tr.backbone.sample = spy
    try:
        b = next(iter(chronological_batches(port_data.train, B)))
        loss, _ = tr.train_step(tr._batch_arrays(b, b.src, b.dst))
        first = tr.evaluate(port_data.val, tr.val_neg)[2]
        second = tr.evaluate(port_data.val, tr.val_neg)[2]
    finally:
        del tr.backbone.sample
    assert np.isfinite(float(loss)) and set(rows) == {4 * B}
    for (p1, n1), (p2, n2) in zip(first, second):
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(n1, n2)
    net = CAWN(compute_dtype="bfloat16").build(172, 172, torch.Generator().manual_seed(0))
    assert net.compute_dtype == net.walk_transformer.compute_dtype == torch.bfloat16
    assert net.feature_encoder.compute_dtype == torch.bfloat16
    assert CAWN().build(172, 172, torch.Generator()).compute_dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        CAWN(compute_dtype="float16")


@pytest.mark.slow
def test_fixture_fit_clears_the_jax_floor(port_data, tmp_path):
    tr = LinkPredictionTrainer(
        CAWN(num_neighbors=8, walk_length=1, num_walk_heads=8), port_data,
        TrainConfig(batch_size=200, num_epochs=2, patience=5, learning_rate=1e-3),
        save_path=str(tmp_path / "cawn.pkl"), device="cpu")
    res = tr.fit(seed=0, log=lambda *a: None)
    assert res["test metrics"]["average_precision"] > 0.58
