"""The trainer's memory-model paths in the port against the JAX trainer on the CPU.

On the JAX test fixture (the 2000-edge synthetic stream, features 172 wide;
K = 5, 1 layer, 2 heads, Dt = 100, dropout 0), with the JAX seed-0
parameters carried by ``from_jax_params`` and a memory that holds train
batches 0 and 1 (JAX's commits: memories and pending messages, so the loss
reaches every parameter of the memory cell):

  * one TGN ``train_step`` on train batch 2 (the triple, random negatives
    from a seeded stream): the loss within 1e-5 and every parameter's
    gradient within 1e-4 of its tensor's largest entry, against
    ``jax.grad`` of the JAX trainer's loss (op by op: jitted, XLA would fuse
    the time encoder's dt * w + b into one rounding where PyTorch rounds
    twice); the committed state against the JAX commit with the same
    pre-update parameters (floats within 1e-5, clocks and flags exact);
  * ``evaluate`` over the val split (two batches, the second padded) for
    each model: probabilities and losses within 1e-5, AP and AUC within
    1e-4 (ties, see the test) and the final state as above, against the JAX
    trainer's ``evaluate``;
  * ``fit`` for TGN above the JAX package's 0.57 test AP floor
    (``tests/test_memory_models.py``), with its result keys and its staging
    (every epoch from an empty memory, val and new-node val from the
    post-train state, no final val sweep, test and new-node test from the
    checkpoint's post-val state); JODIE (0.58) and DyRep (0.39) are marked
    slow, as the JAX file marks them;
  * ``check_memory_order`` catches batches applied out of order, and a
    checkpoint's ``MemoryState`` comes back onto the device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.models.memory_model import MemoryModel as JaxMemoryModel
from dyglib_tpu.models.memory_model import MemoryState as JaxState
from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer
from dyglib_tpu.train import TrainConfig as JaxConfig
from dyglib_tpu_torch.data import chronological_batches, get_link_prediction_data
from dyglib_tpu_torch.models import MemoryModel, MemoryState, compute_src_dst_node_time_shifts
from dyglib_tpu_torch.train import (
    LinkPredictionTrainer,
    TrainConfig,
    load_checkpoint,
    save_checkpoint,
    to_device,
)
from dyglib_tpu_torch.transfer import from_jax_params

K, LR, TRAIN_B = 5, 1e-3, 200
MODELS = ["TGN", "DyRep", "JODIE"]


@pytest.fixture(scope="module")
def port_data(synthetic_dataset):
    return get_link_prediction_data("synthetic", data_root=synthetic_dataset)


def _shifts(d):
    return compute_src_dst_node_time_shifts(d.train.src, d.train.dst, d.train.ts)


def _batches(d, idx):
    """Train batches ``idx`` with negatives from a seeded stream (the same
    numpy arrays feed both trainers)."""
    rng = np.random.RandomState(5)
    out = []
    for i, b in enumerate(chronological_batches(d.train, TRAIN_B)):
        neg = rng.choice(np.unique(d.train.dst), size=len(b.src))
        if i in idx:
            out.append((b, neg))
    return out


@pytest.fixture(scope="module")
def jax_side(link_data, tmp_path_factory):
    """Per model: the JAX trainer, its seed-0 parameters (numpy) and the
    state after committing train batches 0 and 1 (numpy): nodes of both
    hold a memory and a pending message."""
    out = {}
    for name in MODELS:
        jtr = JaxTrainer(
            JaxMemoryModel(model_name=name, num_neighbors=K, num_layers=1, dropout=0.0,
                           time_shifts=_shifts(link_data)),
            link_data, JaxConfig(batch_size=TRAIN_B, learning_rate=LR),
            str(tmp_path_factory.mktemp("jax") / f"{name}.pkl"),
        )
        params, _ = jtr.init_params(0)
        state = jtr.init_state()
        emb = jnp.zeros((TRAIN_B, jtr.tables.node_dim))  # DyRep's partner embeddings
        for b, neg in _batches(link_data, {0, 1}):
            src, dst, _, _, ts, eid, valid = jtr._batch_arrays(b, b.src, neg)
            state = jax.jit(jtr.backbone.commit)(params["backbone"], jtr.tables, state,
                                                 src, dst, ts, eid, valid, emb, emb)
        out[name] = (jtr, jax.tree_util.tree_map(np.asarray, params),
                     [np.asarray(a) for a in state])
    return out


def _port_trainer(port_data, name, params=None, **cfg):
    tr = LinkPredictionTrainer(
        MemoryModel(model_name=name, num_neighbors=K, num_layers=1, dropout=0.0,
                    time_shifts=_shifts(port_data)),
        port_data, TrainConfig(batch_size=TRAIN_B, learning_rate=LR, **cfg), device="cpu",
    )
    tr.init_params(0)
    if params is not None:
        tr.load_params(from_jax_params(params))
    return tr


def _torch_state(arrays):
    return MemoryState(*(torch.from_numpy(np.array(a)) for a in arrays))


def _assert_state_close(ours: MemoryState, ref, where=""):
    for f, want in zip(MemoryState._fields, ref):
        got, want = getattr(ours, f).numpy(), np.asarray(want)
        if got.dtype == np.float32:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=f"{where} {f}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{where} {f}")


def test_tgn_train_step_matches_jax_grad_and_commit(jax_side, port_data):
    jtr, params, state_np = jax_side["TGN"]
    (b, neg), = _batches(port_data, {2})
    jarrays = jtr._batch_arrays(b, b.src, neg)
    jstate = JaxState(*(jnp.asarray(a) for a in state_np))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    def loss_fn(p):
        loss, _, _, raw4 = jtr._forward(p, jtr.train_csr, jtr.tables, jarrays,
                                        jax.random.PRNGKey(0), True, jstate, False, None)
        return loss, raw4

    (jloss, raw4), grads = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    src, dst, _, _, ts, eid, valid = jarrays
    want_state = jtr.backbone.commit(jparams["backbone"], jtr.tables, jstate, src, dst, ts, eid,
                                     valid, raw4[:TRAIN_B], raw4[TRAIN_B : 2 * TRAIN_B])
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, grads))

    tr = _port_trainer(port_data, "TGN", params)
    state = _torch_state(state_np)
    loss, (pos, neg_p), new_state = tr.train_step(tr._batch_arrays(b, b.src, neg), state=state)
    assert abs(float(loss) - float(jloss)) < 1e-5
    got = {"backbone": {k: p.grad for k, p in tr.model.named_parameters()},
           "head": {k: p.grad for k, p in tr.head.named_parameters()}}
    for part in ("backbone", "head"):
        assert set(got[part]) == set(want[part])
        for k, g in got[part].items():
            assert g is not None and torch.isfinite(g).all(), k
            ref = want[part][k].numpy()
            scale = float(np.abs(ref).max())
            assert scale > 0, k
            err = float(np.abs(g.numpy() - ref).max())
            assert err <= 1e-4 * scale, (k, err, scale)
    _assert_state_close(new_state, want_state, "TGN train step")
    # the state went in and out explicitly: the input is untouched
    _assert_state_close(state, state_np, "input state")
    with pytest.raises(ValueError, match="state="):
        tr.train_step(tr._batch_arrays(b, b.src, neg))


@pytest.mark.parametrize("name", MODELS)
def test_evaluate_matches_jax(jax_side, link_data, port_data, name):
    """Probabilities and losses within 1e-5 and the final state as above;
    AP and AUC within 1e-4: they rank the probabilities, and entries tied
    in exact arithmetic (nodes with no memory and no history embed alike)
    may come out of two f32 computations in either order."""
    jtr, params, state_np = jax_side[name]
    recorded = []
    batch_metrics = jtr._batch_metrics

    def record(probs, b):
        recorded.append(jtr._host_probs(probs))
        return batch_metrics(probs, b)

    jtr._batch_metrics = record
    try:
        jlosses, jmetrics, jstate = jtr.evaluate(
            jax.tree_util.tree_map(jnp.asarray, params), link_data.val, jtr.val_neg, 0,
            state=JaxState(*(jnp.asarray(a) for a in state_np)), scanned=False)
    finally:
        jtr._batch_metrics = batch_metrics
    tr = _port_trainer(port_data, name, params)
    losses, metrics, probs, state = tr.evaluate(port_data.val, tr.val_neg, 0,
                                                state=_torch_state(state_np))
    assert len(losses) == len(jlosses) == len(probs) == len(recorded) == 2
    for (pos, neg), (jpos, jneg) in zip(probs, recorded):
        np.testing.assert_allclose(pos, jpos, atol=1e-5, rtol=0)
        np.testing.assert_allclose(neg, jneg, atol=1e-5, rtol=0)
    np.testing.assert_allclose(losses, jlosses, atol=1e-5)
    for ours, ref in zip(metrics, jmetrics):
        for k in ref:
            assert abs(ours[k] - ref[k]) <= 1e-4, (k, ours[k], ref[k])
    _assert_state_close(state, jstate, f"{name} evaluate")
    # an empty split hands the state back unchanged
    empty = tr.evaluate(port_data.val.slice(0, 0), tr.val_neg, state=state)
    assert empty[:3] == ([], [], []) and empty[3] is state


def _fit(port_data, name, tmp_path, calls=None):
    tr = _port_trainer(port_data, name)
    tr.cfg.num_epochs = 2
    tr.cfg.patience = 5
    tr.save_path = str(tmp_path / f"{name}.pkl")
    if calls is not None:
        evaluate = tr.evaluate

        def spy(stream, sampler, salt=0, state=None):
            out = evaluate(stream, sampler, salt, state=state)
            calls.append((salt, state, out[3], tr.mean_metrics(out[1])))
            return out

        tr.evaluate = spy
    return tr.fit(seed=0, log=lambda *a: None)


FIT_FLOOR = {"TGN": 0.57, "JODIE": 0.58, "DyRep": 0.39}  # tests/test_memory_models.py


def test_tgn_fit_stages_the_memory_as_jax(port_data, tmp_path):
    calls = []
    res = _fit(port_data, "TGN", tmp_path, calls)
    assert set(res) == {
        "train losses", "validate metrics", "new node validate metrics", "test metrics",
        "new node test metrics", "params", "state",
    }
    ap = res["test metrics"]["average_precision"]
    assert FIT_FLOOR["TGN"] < ap <= 1.0, ap
    assert len(res["train losses"]) == 2 and np.isfinite(res["train losses"]).all()
    # per epoch val and new-node val from one post-train state; then test and
    # new-node test only, from the checkpoint's state: no final val sweep
    assert [c[0] for c in calls] == [0, 1, 0, 1, 2, 3]
    for epoch in (0, 2):
        assert calls[epoch][1] is calls[epoch + 1][1] is not None
    assert calls[0][1] is not calls[2][1]
    assert calls[4][1] is calls[5][1] is res["state"]
    # the checkpoint holds the best epoch's post-val state
    best = 0 if calls[4][1].memory.equal(calls[0][2].memory) else 2
    for f in MemoryState._fields:
        assert torch.equal(getattr(res["state"], f), getattr(calls[best][2], f)), f
    # the reported val metrics are the last epoch's
    assert res["validate metrics"] == calls[2][3]
    assert res["new node validate metrics"] == calls[3][3]
    assert res["test metrics"] == calls[4][3]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["JODIE", "DyRep"])
def test_fit_clears_the_jax_floor(port_data, tmp_path, name):
    ap = _fit(port_data, name, tmp_path)["test metrics"]["average_precision"]
    assert FIT_FLOOR[name] < ap <= 1.0, ap


def test_check_memory_order_catches_batches_out_of_order(port_data):
    tr = _port_trainer(port_data, "TGN", check_memory_order=True)
    n = port_data.train.num_interactions
    _, _, state = tr.train_epoch(port_data.train.slice(n // 2, n))  # in order: passes
    with pytest.raises(RuntimeError, match="memory order violated"):
        tr.train_epoch(port_data.train.slice(0, n // 2), state=state)


def test_checkpoint_round_trips_a_memory_state(port_data, tmp_path):
    tr = _port_trainer(port_data, "JODIE")
    _, _, _, state = tr.evaluate(port_data.val.slice(0, 400), tr.val_neg)
    path = str(tmp_path / "ck.pkl")
    save_checkpoint(path, tr.state_dicts(), state)
    back = to_device(load_checkpoint(path)["state"], tr.device)
    assert isinstance(back, MemoryState) and back.msg_valid.any()
    for f in MemoryState._fields:
        got, want = getattr(back, f), getattr(state, f)
        assert got.dtype == want.dtype and got.device == want.device and torch.equal(got, want), f
