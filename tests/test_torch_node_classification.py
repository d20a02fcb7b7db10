"""Node classification in the port against the JAX package on the CPU.

On the JAX test fixture (the 2000-edge synthetic stream, features 172
wide), each backbone at a small width with the JAX seed-0 parameters
carried by ``transfer.module_state_dict``:

  * ``MLPClassifier`` against the JAX module (dropout off) within 1e-6, and
    ``node_classification_metrics`` equal to JAX's;
  * ``get_node_classification_data``: every array equal to JAX's; the
    processed layout: the port's ``write_processed`` writes the JAX
    writer's bytes, each package reads the other's files into equal arrays;
  * ``_src_embeddings`` (the frozen backbone's source rows) within 1e-5 of
    JAX's over two train batches for TGAT and GraphMixer (src alone), TGN
    and JODIE ([src || dst], the state after each commit: TGN's and
    JODIE's memory within 1e-6), DyGFormer and TCL (the triple) and CAWN
    (the quad; recent sampling, so both draw the same walks);
  * ``train_step`` against ``jax.value_and_grad`` of the JAX trainer's loss
    on the padded last batch, head dropout 0: loss within 1e-5, head
    gradients within 1e-4 of each tensor's largest entry, no backbone
    ``.grad``;
  * ``evaluate`` over the val split for TGAT and TGN: probabilities within
    1e-5 and the global AUC within 1e-6;
  * ``fit`` (2 epochs, head dropout 0, the JAX head init) for TGAT and
    JODIE: each epoch's mean loss within 1e-4 of JAX's, JODIE's memory
    after the last train sweep within 1e-5.
"""
import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dyglib_tpu import models as jax_models
from dyglib_tpu.data import get_link_prediction_data as jax_link_data
from dyglib_tpu.data import get_node_classification_data as jax_nc_data
from dyglib_tpu.data import write_synthetic_dataset as jax_write_synthetic
from dyglib_tpu.data.batching import chronological_batches as jax_batches
from dyglib_tpu.models import compute_src_dst_node_time_shifts as jax_shifts
from dyglib_tpu.nn.modules import MLPClassifier as JaxMLPClassifier
from dyglib_tpu.train import TrainConfig as JaxConfig
from dyglib_tpu.train.metrics import node_classification_metrics as jax_nc_metrics
from dyglib_tpu.train.node_classification import NodeClassificationTrainer as JaxTrainer
from dyglib_tpu_torch import models
from dyglib_tpu_torch.data import (
    chronological_batches,
    get_link_prediction_data,
    get_node_classification_data,
    write_synthetic_dataset,
)
from dyglib_tpu_torch.models import compute_src_dst_node_time_shifts
from dyglib_tpu_torch.nn import MLPClassifier
from dyglib_tpu_torch.train import (
    NodeClassificationTrainer,
    TrainConfig,
    node_classification_metrics,
)
from dyglib_tpu_torch.transfer import module_state_dict

B, LR = 200, 1e-3
# small widths of every backbone; CAWN under recent so both sides walk alike
BACKBONES = {
    "TGAT": dict(num_neighbors=5, num_layers=1),
    "GraphMixer": dict(num_neighbors=5, num_layers=1, time_gap=50),
    "TGN": dict(num_neighbors=5, num_layers=1),
    "JODIE": dict(num_neighbors=5, num_layers=1),
    "DyGFormer": dict(max_input_sequence_length=16, patch_size=2, num_layers=1),
    "TCL": dict(num_neighbors=5, num_layers=1),
    "CAWN": dict(num_neighbors=4, walk_length=1, num_walk_heads=2, position_feat_dim=16,
                 sample_strategy="recent"),
}
MEMORY = ("TGN", "JODIE")
LAYOUT_ROWS = {"TGAT": 1, "GraphMixer": 1, "TGN": 2, "JODIE": 2, "DyGFormer": 3, "TCL": 3,
               "CAWN": 4}


def _backbones(name, jax_link, port_link):
    kw = dict(BACKBONES[name], dropout=0.0)
    if name in MEMORY:
        jb = jax_models.MemoryModel(
            model_name=name, time_shifts=jax_shifts(jax_link.train.src, jax_link.train.dst,
                                                    jax_link.train.ts), **kw)
        pb = models.MemoryModel(
            model_name=name, time_shifts=compute_src_dst_node_time_shifts(
                port_link.train.src, port_link.train.dst, port_link.train.ts), **kw)
        return jb, pb
    if name == "CAWN":
        return jax_models.CAWN(compute_dtype="float32", **kw), models.CAWN(**kw)
    return getattr(jax_models, name)(**kw), getattr(models, name)(**kw)


def make_pair(name, jax_nc, jax_link, port_nc, port_link, tmp, batch_size=B, **cfg):
    """The JAX trainer with its seed-0 backbone parameters (set as its
    ``backbone_params``), and the port's trainer holding the same ones."""
    jb, pb = _backbones(name, jax_link, port_link)
    jtr = JaxTrainer(jb, jax_nc, JaxConfig(batch_size=batch_size, learning_rate=LR, **cfg),
                     str(tmp / f"jax_{name}.pkl"), None)
    params = jax.jit(jb.init)(jax.random.PRNGKey(0), jtr.tables, jtr.full_csr)
    jtr.backbone_params = params
    tr = NodeClassificationTrainer(
        pb, port_nc, TrainConfig(batch_size=batch_size, learning_rate=LR, **cfg),
        str(tmp / f"port_{name}.pkl"),
        module_state_dict(jax.tree_util.tree_map(np.asarray, params)), device="cpu")
    return jtr, tr


def jax_head(jtr, seed=0):
    head_params, _ = jtr.init_params(seed)
    return head_params, module_state_dict(jax.tree_util.tree_map(np.asarray, head_params))


@pytest.fixture(scope="module")
def splits(synthetic_dataset):
    """(JAX node-class data, JAX link data, port node-class data, port link data)."""
    return (jax_nc_data("synthetic", data_root=synthetic_dataset),
            jax_link_data("synthetic", data_root=synthetic_dataset),
            get_node_classification_data("synthetic", data_root=synthetic_dataset),
            get_link_prediction_data("synthetic", data_root=synthetic_dataset))


def test_mlp_classifier_matches_jax():
    head = JaxMLPClassifier(dropout=0.1)
    params = head.init(jax.random.PRNGKey(3), jnp.zeros((1, 172)))
    x = np.random.RandomState(0).normal(size=(64, 172)).astype(np.float32)
    want = np.asarray(head.apply(params, jnp.asarray(x), train=False))
    ours = MLPClassifier(172, torch.Generator().manual_seed(0), dropout=0.1)
    ours.load_state_dict(module_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    got = ours.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (64, 1)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    ours.train()
    with pytest.raises(ValueError, match="dropout_gen"):
        ours(torch.from_numpy(x))


def test_node_classification_metrics_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(5):
        labels = (rng.rand(500) < 0.1).astype(np.float64)
        scores = np.round(rng.rand(500), 2)  # many ties
        assert node_classification_metrics(scores, labels) == jax_nc_metrics(scores, labels)


def test_node_classification_split_matches_jax(splits):
    jax_nc, _, port_nc, _ = splits
    np.testing.assert_array_equal(port_nc.node_raw_features, jax_nc.node_raw_features)
    np.testing.assert_array_equal(port_nc.edge_raw_features, jax_nc.edge_raw_features)
    for split in ("full", "train", "val", "test"):
        ours, ref = getattr(port_nc, split), getattr(jax_nc, split)
        assert ours.num_interactions == ref.num_interactions > 0
        for field in ("src", "dst", "ts", "eid", "label"):
            np.testing.assert_array_equal(getattr(ours, field), getattr(ref, field), split)
    assert port_nc.num_nodes == jax_nc.num_nodes


def test_processed_layout_reads_across_packages(tmp_path):
    kw = dict(num_src=40, num_dst=20, num_edges=600, node_feat_scale=1.0, seed=11,
              time_span=3.3e7)
    write_synthetic_dataset(str(tmp_path / "port"), "s", **kw)
    jax_write_synthetic(str(tmp_path / "jax"), "s", **kw)
    for suffix in (".csv", ".npy", "_node.npy"):
        assert filecmp.cmp(tmp_path / "port" / "s" / f"ml_s{suffix}",
                           tmp_path / "jax" / "s" / f"ml_s{suffix}", shallow=False), suffix
    jax_reads_port = jax_link_data("s", data_root=str(tmp_path / "port"))
    port_reads_jax = get_link_prediction_data("s", data_root=str(tmp_path / "jax"))
    for a, b in ((jax_reads_port, jax_link_data("s", data_root=str(tmp_path / "jax"))),
                 (port_reads_jax, get_link_prediction_data("s", data_root=str(tmp_path / "port")))):
        np.testing.assert_array_equal(a.node_raw_features, b.node_raw_features)
        np.testing.assert_array_equal(a.edge_raw_features, b.edge_raw_features)
        for split in ("full", "train", "val", "test", "new_node_val", "new_node_test"):
            for field in ("src", "dst", "ts", "eid", "label"):
                np.testing.assert_array_equal(getattr(getattr(a, split), field),
                                              getattr(getattr(b, split), field))
    np.testing.assert_array_equal(port_reads_jax.full.ts, jax_reads_port.full.ts)
    assert port_reads_jax.full.label.sum() > 0


def _state_close(ours, ref, atol):
    for field, want in zip(type(ours)._fields, ref):
        got, want = getattr(ours, field).numpy(), np.asarray(want)
        if got.dtype == np.float32:
            np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=field)
        else:
            np.testing.assert_array_equal(got, want, err_msg=field)


@pytest.mark.parametrize("name", list(BACKBONES))
def test_src_embeddings_match_jax(splits, tmp_path, name):
    jtr, tr = make_pair(name, *splits, tmp_path)
    assert len(tr.layout) == LAYOUT_ROWS[name]
    jax_embed = jax.jit(jtr._src_embeddings)
    jstate, state = jtr.init_state(), tr.init_state()
    batches = list(jax_batches(splits[0].train, B))[:2]
    for b, pb in zip(batches, chronological_batches(splits[2].train, B)):
        want, jstate = jax_embed(jtr.full_csr, jtr.tables, jtr._batch_arrays(b),
                                 jax.random.PRNGKey(1), jstate)
        got, state = tr._src_embeddings(tr._batch_arrays(pb), state)
        assert got.shape == (B, 172) and not got.requires_grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        if name in MEMORY:
            _state_close(state, jstate, atol=1e-6)
            assert state.msg_valid.any()
        else:
            assert state is None
    assert all(p.grad is None and not p.requires_grad for p in tr.model.parameters())


def _jax_loss(jtr, head_params, src_emb, labels, valid):
    logits = jtr.head.apply(head_params, src_emb, train=False)[..., 0]
    bce = optax.sigmoid_binary_cross_entropy(logits, labels)
    return (bce * valid).sum() / jnp.maximum(valid.sum(), 1.0)


@pytest.mark.parametrize("name", ["TGAT", "TGN"])
def test_train_step_matches_jax_value_and_grad(splits, tmp_path, name):
    bs = 128  # the last train batch is padded: 1400 = 10 x 128 + 120
    jtr, tr = make_pair(name, *splits, tmp_path, batch_size=bs, head_dropout=0.0)
    jb = list(jax_batches(splits[0].train, bs))[-1]
    pb = list(chronological_batches(splits[2].train, bs))[-1]
    assert pb.num_valid < bs and pb.label[: pb.num_valid].sum() > 0
    arrays = jtr._batch_arrays(jb)
    src_emb, jstate = jax.jit(jtr._src_embeddings)(jtr.full_csr, jtr.tables, arrays,
                                                   jax.random.PRNGKey(1), jtr.init_state())
    head_params, head_sd = jax_head(jtr)
    labels = jnp.asarray(jb.label, jnp.float32)
    jloss, grads = jax.value_and_grad(_jax_loss, argnums=1)(
        jtr, head_params, src_emb, labels, arrays[-1])
    tr.init_params(0)
    tr.load_head(head_sd)
    loss, probs, state = tr.train_step(tr._batch_arrays(pb),
                                       torch.from_numpy(pb.label.astype(np.float32)),
                                       tr.init_state())
    assert abs(float(loss) - float(jloss)) <= 1e-5
    assert probs.shape == (bs,)
    want = module_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    assert set(want) == {k for k, _ in tr.head.named_parameters()}
    for k, p in tr.head.named_parameters():
        ref = want[k].numpy()
        assert float(np.abs(p.grad.numpy() - ref).max()) <= 1e-4 * float(np.abs(ref).max()), k
    assert all(p.grad is None for p in tr.model.parameters())
    if name in MEMORY:
        _state_close(state, jstate, atol=1e-6)


def _recording(step, out: list):
    def run(*args, **kw):
        probs, state = step(*args, **kw)
        out.append(np.array(probs))
        return probs, state
    return run


@pytest.mark.parametrize("name", ["TGAT", "TGN"])
def test_evaluate_matches_jax(splits, tmp_path, name):
    jtr, tr = make_pair(name, *splits, tmp_path)
    head_params, head_sd = jax_head(jtr)
    tr.load_head(head_sd)
    jprobs, probs = [], []
    jtr.eval_step = _recording(jtr.eval_step, jprobs)
    tr.eval_step = _recording(tr.eval_step, probs)
    jm, jstate = jtr.evaluate(head_params, splits[0].val, state=jtr.init_state(), salt=0)
    m, state = tr.evaluate(splits[2].val, salt=0)
    assert len(probs) == len(jprobs) == 2  # 300 val rows: the second batch padded
    for p, jp in zip(probs, jprobs):
        np.testing.assert_allclose(p, jp, atol=1e-5, rtol=0)
    assert np.isfinite(m["roc_auc"]) and abs(m["roc_auc"] - jm["roc_auc"]) <= 1e-6
    if name in MEMORY:
        _state_close(state, jstate, atol=1e-5)


@pytest.mark.parametrize("name", ["TGAT", "JODIE"])
def test_fit_matches_jax(splits, tmp_path, name):
    jtr, tr = make_pair(name, *splits, tmp_path, head_dropout=0.0, num_epochs=2, patience=5)
    _, head_sd = jax_head(jtr)
    init_params = tr.init_params

    def init_from_jax(seed):
        init_params(seed)
        tr.load_head(head_sd)

    tr.init_params = init_from_jax
    jlosses, train_states = [], {}
    jax_step = jtr.train_step

    def jax_recording_step(*args):
        out = jax_step(*args)
        jlosses.append(float(out[3]))
        return out

    jtr.train_step = jax_recording_step

    def recording_evaluate(side, evaluate):
        def run(*args, **kw):
            if kw.get("salt") == 0:
                train_states[side] = kw["state"]
            return evaluate(*args, **kw)
        return run

    jtr.evaluate = recording_evaluate("jax", jtr.evaluate)
    tr.evaluate = recording_evaluate("port", tr.evaluate)
    jres = jtr.fit(seed=0, log=lambda *a: None)
    res = tr.fit(seed=0, log=lambda *a: None)
    n = len(jlosses) // 2
    want = [float(np.mean(jlosses[:n])), float(np.mean(jlosses[n:]))]
    np.testing.assert_allclose(res["train losses"], want, atol=1e-4, rtol=0)
    assert set(res) >= {"validate metrics", "test metrics", "head_params"}
    for split in ("validate metrics", "test metrics"):
        assert abs(res[split]["roc_auc"] - jres[split]["roc_auc"]) <= 1e-4
    if name in MEMORY:
        _state_close(train_states["port"], train_states["jax"], atol=1e-5)
