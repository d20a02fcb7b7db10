"""The port's DyGFormer training against the JAX package on the CPU.

  * gradients: with dropout 0, the port's parameter gradients after one
    train step equal ``jax.grad`` of the JAX trainer's loss on the same
    injected batch (negatives, bucket and parameters shared), through the
    plain path and through the kernel wrappers' autograd.Functions;
  * optimizers: torch Adam (weight decay 0 and > 0), SGD and the port's
    optax-rule RMSprop against ``make_optimizer`` on identical gradients;
  * a 3-step loss trajectory and the parameters after it;
  * EarlyStopping's decisions, the checkpoint round trip, dropout drawn
    from the trainer's generator, and a 1-epoch ``fit`` that returns the
    JAX package's results keys.

Tolerances:
  * gradients: 2e-5 relative to each tensor's largest entry (both sides are
    f32; the frameworks order their sums differently, and the backward
    chains a few dozen ops). A gradient that is zero in theory (below 1e-6
    of the largest entry of any tensor) is only required to stay below
    1e-5 of it;
  * optimizers on identical gradients: 1e-6 absolute (a few f32 ulps of
    O(1) parameters over 5 steps);
  * the trajectory: the first loss within 1e-5 (one forward), the later two
    within 1e-4, and the parameters within 6 lr. Adam divides each gradient
    by its own running RMS, so a gradient that is pure rounding noise on
    both sides (~1e-9, e.g. the exactly-zero-in-theory k_proj bias) still
    moves its parameter by up to lr, in a direction the noise picks: two
    steps of opposite sign on the two sides differ by 2 lr per step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dyglib_tpu.models import DyGFormer as JaxDyGFormer
from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer
from dyglib_tpu.train import TrainConfig as JaxConfig
from dyglib_tpu.train.checkpoints import load_checkpoint as jax_load_checkpoint
from dyglib_tpu.train.early_stopping import EarlyStopping as JaxEarlyStopping
from dyglib_tpu.train.link_prediction import make_optimizer as jax_make_optimizer
from dyglib_tpu_torch.data import chronological_batches, get_link_prediction_data
from dyglib_tpu_torch.models import DyGFormer
from dyglib_tpu_torch.train import (
    EarlyStopping,
    LinkPredictionTrainer,
    TrainConfig,
    load_checkpoint,
    make_optimizer,
    save_checkpoint,
)
from dyglib_tpu_torch.transfer import from_jax_params

LR = 1e-4
KW = dict(max_input_sequence_length=32, patch_size=4, num_layers=2, dropout=0.0)


@pytest.fixture(scope="module")
def jax_side(link_data, tmp_path_factory):
    jtr = JaxTrainer(
        JaxDyGFormer(**KW, use_time_kernel=False, gelu_approximate=False), link_data,
        JaxConfig(batch_size=200, learning_rate=LR), str(tmp_path_factory.mktemp("j") / "c.pkl"),
    )
    params, opt_state = jtr.init_params(0)
    return jtr, jax.tree_util.tree_map(np.asarray, params), opt_state


@pytest.fixture(scope="module")
def port_data(synthetic_dataset):
    return get_link_prediction_data("synthetic", data_root=synthetic_dataset)


def _port(port_data, params, use_kernels=True, **cfg):
    tr = LinkPredictionTrainer(
        DyGFormer(**KW, use_kernels=use_kernels), port_data,
        TrainConfig(batch_size=200, learning_rate=LR, **cfg), device="cpu",
    )
    tr.init_params(0)
    tr.load_params(from_jax_params(params))
    return tr


def _batches(port_data, idx):
    """Train batches ``idx`` with negatives from a seeded stream (the same
    numpy arrays feed both trainers)."""
    rng = np.random.RandomState(5)
    out = []
    for i, b in enumerate(chronological_batches(port_data.train, 200)):
        neg = rng.choice(np.unique(port_data.train.dst), size=len(b.src))
        if i in idx:
            out.append((b, neg))
    return out


def _named_grads(tr):
    return {
        "backbone": {k: p.grad for k, p in tr.model.named_parameters()},
        "head": {k: p.grad for k, p in tr.head.named_parameters()},
    }


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "wrappers"])
def test_gradients_match_jax_grad(jax_side, port_data, use_kernels):
    jtr, params, _ = jax_side
    tr = _port(port_data, params, use_kernels)
    (b, neg), = _batches(port_data, {2})
    bucket = tr._pick_bucket(tr.train_csr, b, b.src, neg)
    assert bucket == jtr._pick_bucket(jtr.train_csr, b, b.src, neg)
    jarrays = jtr._batch_arrays(b, b.src, neg)

    def loss_fn(p):
        return jtr._forward(p, jtr.train_csr, jtr.tables, jarrays, jax.random.PRNGKey(0), True,
                            None, False, bucket)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, params))
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    loss, _ = tr.train_step(tr._batch_arrays(b, b.src, neg), bucket)
    assert abs(float(loss) - float(jloss)) < 1e-5
    got = _named_grads(tr)
    global_scale = max(float(v.abs().max()) for sd in want.values() for v in sd.values())
    for part in ("backbone", "head"):
        assert set(got[part]) == set(want[part])
        for k, g in got[part].items():
            assert g is not None and torch.isfinite(g).all(), k
            ref = want[part][k].numpy()
            scale = float(np.abs(ref).max())
            if scale < 1e-6 * global_scale:
                # zero in theory (the k_proj bias: softmax ignores a shift
                # of the keys); both sides hold rounding noise
                assert float(g.abs().max()) < 1e-5 * global_scale, k
                continue
            np.testing.assert_allclose(g.numpy() / scale, ref / scale, atol=2e-5, err_msg=k)


@pytest.mark.parametrize(
    "optimizer,weight_decay", [("adam", 0.0), ("adam", 0.3), ("sgd", 0.0), ("rmsprop", 0.0)]
)
def test_optimizer_matches_make_optimizer(optimizer, weight_decay):
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=w0.shape).astype(np.float32) for _ in range(5)]
    kw = dict(learning_rate=1e-2, weight_decay=weight_decay, optimizer=optimizer)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = make_optimizer(TrainConfig(**kw), [tw])
    tx = jax_make_optimizer(JaxConfig(**kw))
    params = {"w": jnp.asarray(w0)}
    state = tx.init(params)
    for g in grads:
        opt.zero_grad()
        tw.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(params["w"]), atol=1e-6)
    assert np.abs(tw.detach().numpy() - w0).max() > 1e-3  # the steps moved it


def test_three_step_trajectory_matches_jax(jax_side, port_data):
    jtr, params, opt_state = jax_side
    tr = _port(port_data, params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for step, (b, neg) in enumerate(_batches(port_data, {0, 1, 2})):
        bucket = tr._pick_bucket(tr.train_csr, b, b.src, neg)
        jp, opt_state, _, jloss, _ = jtr.train_step(
            jp, opt_state, None, jtr.train_csr, jtr._batch_arrays(b, b.src, neg),
            jax.random.PRNGKey(step), bucket,
        )
        loss, _ = tr.train_step(tr._batch_arrays(b, b.src, neg), bucket)
        assert abs(float(loss) - float(jloss)) < (1e-5 if step == 0 else 1e-4), step
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    for part, got in tr.state_dicts().items():
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[part][k].numpy(), atol=6 * LR, err_msg=k)


def test_dropout_draws_from_the_trainer_generator(port_data):
    """Train-mode dropout: the same seed gives the same step; the masks
    change the loss; the global RNG is not read."""
    (b, neg), = _batches(port_data, {2})

    def step_loss(dropout, seed):
        tr = LinkPredictionTrainer(
            DyGFormer(**{**KW, "dropout": dropout}), port_data, TrainConfig(batch_size=200),
            device="cpu",
        )
        tr.init_params(seed)
        torch.manual_seed(seed + 100)  # the global stream, which must not matter
        return float(tr.train_step(tr._batch_arrays(b, b.src, neg))[0])

    assert step_loss(0.1, 3) == step_loss(0.1, 3)
    assert step_loss(0.1, 3) != step_loss(0.0, 3)


def test_early_stopping_matches_jax(tmp_path):
    seq = [
        {"ap": 0.5, "auc": 0.5}, {"ap": 0.6, "auc": 0.5}, {"ap": 0.6, "auc": 0.6},
        {"ap": 0.7, "auc": 0.55}, {"ap": 0.6, "auc": 0.7}, {"ap": 0.7, "auc": 0.6},
        {"ap": 0.7, "auc": 0.6}, {"ap": 0.5, "auc": 0.5}, {"ap": 0.4, "auc": 0.4},
    ]
    ours = EarlyStopping(3, str(tmp_path / "ours.pkl"))
    ref = JaxEarlyStopping(3, str(tmp_path / "ref.pkl"))
    for i, m in enumerate(seq):
        params = {"backbone": {"w": np.full(2, i, np.float32)}, "head": {}}
        assert ours.step(m, params) == ref.step(m, params), i
        assert (ours.counter, ours.best) == (ref.counter, ref.best), i
        np.testing.assert_array_equal(
            ours.load_best()["params"]["backbone"]["w"], ref.load_best()["params"]["backbone"]["w"]
        )


def test_checkpoint_round_trip(port_data, tmp_path):
    tr = LinkPredictionTrainer(DyGFormer(**KW), port_data, TrainConfig(), device="cpu")
    tr.init_params(1)
    path = str(tmp_path / "sub" / "ck.pkl")
    save_checkpoint(path, tr.state_dicts(), extra={"epoch": 2})
    ck = load_checkpoint(path)
    assert set(ck) == {"params", "state", "extra"} and ck["extra"] == {"epoch": 2}
    assert ck["state"] is None
    jck = jax_load_checkpoint(path)  # the JAX package reads the same container
    for part, sd in ck["params"].items():
        for k, v in sd.items():
            np.testing.assert_array_equal(jck["params"][part][k], v)
    other = LinkPredictionTrainer(DyGFormer(**KW), port_data, TrainConfig(), device="cpu")
    other.init_params(2)
    other.load_params(ck["params"])
    for part, sd in tr.state_dicts().items():
        for k, v in sd.items():
            torch.testing.assert_close(other.state_dicts()[part][k], v, rtol=0, atol=0)


def test_fit_one_epoch_returns_the_jax_results_keys(port_data, tmp_path):
    backbone = DyGFormer(
        max_input_sequence_length=16, patch_size=2, channel_embedding_dim=8, num_layers=1,
        time_feat_dim=8,
    )
    tr = LinkPredictionTrainer(
        backbone, port_data,
        TrainConfig(batch_size=200, num_epochs=1, learning_rate=5e-4, test_interval_epochs=1),
        save_path=str(tmp_path / "best.pkl"), device="cpu",
    )
    logs = []
    res = tr.fit(seed=0, log=logs.append)
    assert set(res) == {
        "train losses", "validate metrics", "new node validate metrics", "test metrics",
        "new node test metrics", "params", "state",
    }
    assert len(res["train losses"]) == 1 and np.isfinite(res["train losses"]).all()
    for key in ("validate metrics", "test metrics"):
        assert set(res[key]) == {"average_precision", "roc_auc"}
        assert all(0.0 <= v <= 1.0 for v in res[key].values())
    assert (tmp_path / "best.pkl").exists() and any("epoch 1" in line for line in logs)
