"""Scan epochs in the port: against the JAX package's scan path and the
port's own loop on the CPU, and captured against eager on a card.

On the JAX test fixture (the 2000-edge synthetic stream, features 172
wide; TGAT and TGN at K = 5, 1 layer; DyGFormer 16/2, 1 layer; dropout
0), with the JAX seed-0 parameters carried by ``transfer.from_jax_params``:

  * ``train_epoch_scanned`` against the JAX ``train_epoch_scanned`` over a
    three-batch train split (seeded negatives, the same on both sides):
    the tolerance of ``test_torch_train.py::test_three_step_trajectory_
    matches_jax`` (first loss within 1e-5, the later within 1e-4, the
    parameters within 6 lr), TGN's memory after the epoch and its pending
    messages' memory and edge columns within 10 lr (each commit reads the
    parameters, which agree to 6 lr, through the GRU's sums over some 600
    inputs), its clocks and flags exact. The messages' time-feature columns
    are left out: they hold cos(w dt + b) with dt up to ~1e6, so time
    frequencies that agree to ~1 lr give unrelated phases. Adam's first
    steps move each parameter by about lr whatever its gradient's size, so
    those bounds would pass an epoch that never stepped; the epoch's update
    as a whole is held too: the parameters' change from their start, all
    tensors together, within UPDATE_RTOL of the JAX change's norm (0.002
    to 0.07 measured; an epoch with one of its three optimizer steps left
    out gives 0.31-0.37), and TGN's memory within MEMORY_RTOL of its norm
    (2.1e-4 measured; an epoch without optimizer steps gives 0.59). Entry
    by entry the changes differ by up to ~3 lr where a gradient is near
    Adam's eps;
  * ``evaluate(scanned=True)`` against the JAX ``eval_scan`` for TGN from
    an empty memory: probabilities and losses within 1e-5, the final state
    within 1e-5 (clocks and flags exact); DyGFormer with sequence buckets
    falls back to the per-batch sweep under ``scan_epochs``, as the JAX rule
    (``scan_epochs and not buckets``) does, and scans without them;
  * node classification's scanned head epoch and scanned ``evaluate``
    against the JAX ``train_scan`` and ``eval_scan`` (TGAT, TGN; head
    dropout 0): losses within 1e-5, probabilities within 1e-5, AUC within
    1e-6, TGN's memory after the head epoch within 1e-5;
  * the port's scan against its own loop (dropout 0.1, TGAT under
    ``uniform``, TGN, DyGFormer without buckets, node classification): on
    the CPU both run the same eager steps, so losses, probabilities,
    parameters, memory and every generator's state are bitwise equal;
  * ``cuda`` tests (skipped without a card): the captured graphs against
    eager steps on the card (losses and probabilities within 1e-5,
    parameters within 1e-5, memory within 1e-5 and clocks exact,
    generator states equal), the replays' launches equal to the eager
    loop's, node classification's captured head epoch and sweep (TGN,
    DyGFormer) against eager ones, a replay that reads its static inputs,
    a capture's launches counted apart from eager ones, eval sweeps with
    salts 0, 2 and 0 through one cached graph against eager sweeps with
    those salts (TGAT ``uniform``), and a 2-epoch ``fit`` with
    ``scan_epochs`` against ``fit`` on the loop's steps with the same
    (``capturable``) Adam (metrics, train losses and the checkpoint's
    weights within 1e-5).

The JAX package is imported inside the tests that use it: the ``cuda``
tests run on the card's machine, which has no JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_scan.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from dyglib_tpu_torch import ops
from dyglib_tpu_torch.data import (
    get_link_prediction_data,
    get_node_classification_data,
    synthetic_link_prediction_data,
)
from dyglib_tpu_torch.graph import NegativeEdgeSampler
from dyglib_tpu_torch.models import (
    TGAT,
    DyGFormer,
    MemoryModel,
    MemoryState,
    compute_src_dst_node_time_shifts,
)
from dyglib_tpu_torch.train import LinkPredictionTrainer, NodeClassificationTrainer, TrainConfig
from dyglib_tpu_torch.transfer import from_jax_params, module_state_dict

LR, B, TRAIN_EDGES = 1e-4, 200, 600
# the scanned epoch's update against the JAX one, in norm (see above)
UPDATE_RTOL, MEMORY_RTOL = 0.15, 2e-3
DYG = dict(max_input_sequence_length=16, patch_size=2, num_layers=1)
JAX_TGAT_PLAIN = dict(compute_dtype="float32", use_fused_attention=False,
                      use_window_attention=False, use_gathered_attention=False,
                      use_phi_fusion=False)


def _shifts(d):
    return compute_src_dst_node_time_shifts(d.train.src, d.train.dst, d.train.ts)


def _port_backbone(name, d, dropout=0.0, **kw):
    if name == "TGAT":
        return TGAT(num_neighbors=5, num_layers=1, dropout=dropout, **kw)
    if name == "TGN":
        return MemoryModel("TGN", num_neighbors=5, num_layers=1, dropout=dropout,
                           time_shifts=_shifts(d))
    return DyGFormer(**DYG, dropout=dropout)


def _jax_backbone(name, jd):
    from dyglib_tpu import models as jm

    if name == "TGAT":
        return jm.TGAT(num_neighbors=5, num_layers=1, dropout=0.0, **JAX_TGAT_PLAIN)
    if name == "TGN":
        shifts = jm.compute_src_dst_node_time_shifts(jd.train.src, jd.train.dst, jd.train.ts)
        return jm.MemoryModel(model_name="TGN", num_neighbors=5, num_layers=1, dropout=0.0,
                              time_shifts=shifts)
    return jm.DyGFormer(**DYG, dropout=0.0, use_time_kernel=False, gelu_approximate=False)


def _short(d):
    """The split with its train stream cut to TRAIN_EDGES (three batches)."""
    return dataclasses.replace(d, train=d.train.slice(0, TRAIN_EDGES))


@pytest.fixture(scope="module")
def port_data(synthetic_dataset):
    return get_link_prediction_data("synthetic", data_root=synthetic_dataset)


def _pair(name, link_data, port_data, tmp_path, **cfg):
    """(JAX trainer, its seed-0 parameters as numpy, the port's trainer
    holding them), both on the three-batch train split with train negatives
    from the same seeded stream."""
    from dyglib_tpu.graph import NegativeEdgeSampler as JaxNegativeEdgeSampler
    from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer
    from dyglib_tpu.train import TrainConfig as JaxConfig
    from tests.torch_parity import jax_params, port_trainer

    jd, pd = _short(link_data), _short(port_data)
    jtr = JaxTrainer(_jax_backbone(name, jd), jd,
                     JaxConfig(batch_size=B, learning_rate=LR, **cfg), str(tmp_path / "j.pkl"))
    params = jax_params(jtr)
    tr = port_trainer(_port_backbone(name, pd), pd, params, batch_size=B, learning_rate=LR,
                      **cfg)
    jtr.train_neg = JaxNegativeEdgeSampler(jd.train.src, jd.train.dst, seed=42)
    tr.train_neg = NegativeEdgeSampler(pd.train.src, pd.train.dst, seed=42)
    return jtr, params, tr


def _assert_state_close(ours: MemoryState, ref, atol, where="", msg_cols=slice(None)):
    for f, want in zip(MemoryState._fields, ref):
        got, want = getattr(ours, f).numpy(), np.asarray(want)
        if f == "msg":
            got, want = got[:, msg_cols], want[:, msg_cols]
        if got.dtype == np.float32:
            np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=f"{where} {f}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{where} {f}")


@pytest.mark.parametrize("name", ["TGAT", "TGN", "DyGFormer"])
def test_scanned_train_epoch_matches_jax(link_data, port_data, tmp_path, name):
    import jax
    import jax.numpy as jnp

    jtr, params, tr = _pair(name, link_data, port_data, tmp_path)
    start = from_jax_params(params)
    _, opt_state = jtr.init_params(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jp, _, jstate, jlosses, _ = jtr.train_epoch_scanned(
        jp, opt_state, jtr.init_state(), 0, jax.random.PRNGKey(0))
    out = tr.train_epoch_scanned()
    losses = out[0]
    assert len(losses) == len(jlosses) == 3
    for step, (ours, ref) in enumerate(zip(losses, jlosses)):
        assert abs(ours - float(ref)) < (1e-5 if step == 0 else 1e-4), (step, ours, ref)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    miss = change = 0.0
    for part, got in tr.state_dicts().items():
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[part][k].numpy(), atol=6 * LR,
                                       err_msg=k)
            p0 = start[part][k].numpy().astype(np.float64)
            ours, ref = v.numpy() - p0, want[part][k].numpy() - p0
            miss += np.square(ours - ref).sum()
            change += np.square(ref).sum()
    assert np.sqrt(miss / change) <= UPDATE_RTOL, np.sqrt(miss / change)
    if name == "TGN":  # a message: [memory, partner memory, time features, edge features]
        m, dt = out[2].memory.shape[1], tr.model.time_encoder.w.shape[1]
        not_time = np.r_[0 : 2 * m, 2 * m + dt : out[2].msg.shape[1]]
        _assert_state_close(out[2], jstate, 10 * LR, "after the epoch", not_time)
        ours, ref = out[2].memory.numpy(), np.asarray(jstate.memory)
        assert np.linalg.norm(ours - ref) <= MEMORY_RTOL * np.linalg.norm(ref)


def test_scanned_evaluate_matches_jax_eval_scan(link_data, port_data, tmp_path):
    import jax
    import jax.numpy as jnp

    jtr, params, tr = _pair("TGN", link_data, port_data, tmp_path)
    recorded = []
    batch_metrics = jtr._batch_metrics

    def record(probs, b):
        recorded.append(jtr._host_probs(probs))
        return batch_metrics(probs, b)

    jtr._batch_metrics = record
    try:
        jlosses, _, jstate = jtr.evaluate(jax.tree_util.tree_map(jnp.asarray, params),
                                          link_data.val, jtr.val_neg, 0,
                                          state=jtr.init_state(), scanned=True)
    finally:
        jtr._batch_metrics = batch_metrics
    losses, _, probs, state = tr.evaluate(port_data.val, tr.val_neg, 0, scanned=True)
    assert len(probs) == len(recorded) == len(jlosses) == 2
    for (pos, neg), (jpos, jneg) in zip(probs, recorded):
        np.testing.assert_allclose(pos, jpos, atol=1e-5, rtol=0)
        np.testing.assert_allclose(neg, jneg, atol=1e-5, rtol=0)
    np.testing.assert_allclose(losses, jlosses, atol=1e-5)
    _assert_state_close(state, jstate, 1e-5, "after the sweep")


@pytest.mark.parametrize("buckets", [True, False], ids=["buckets", "no_buckets"])
def test_dygformer_evaluate_scans_only_without_buckets(link_data, port_data, tmp_path,
                                                      monkeypatch, buckets):
    jtr, _, tr = _pair("DyGFormer", link_data, port_data, tmp_path, scan_epochs=True,
                       sequence_buckets=buckets)
    assert bool(jtr._buckets) == bool(tr._buckets) == buckets  # the JAX rule's input
    scans = []
    scan = tr.graphs.scan
    monkeypatch.setattr(tr.graphs, "scan", lambda *a, **kw: scans.append(1) or scan(*a, **kw))
    losses, _, probs = tr.evaluate(port_data.val, tr.val_neg, 0)
    assert len(scans) == (0 if buckets else 1)
    loop = tr.evaluate(port_data.val, tr.val_neg, 0, scanned=False)
    np.testing.assert_allclose(losses, loop[0], atol=1e-6)
    for (pos, neg), (lpos, lneg) in zip(probs, loop[2]):
        np.testing.assert_allclose(pos, lpos, atol=1e-6, rtol=0)
        np.testing.assert_allclose(neg, lneg, atol=1e-6, rtol=0)


# ---------------------------------------------------------- node classification
def _nc_pair(name, synthetic_dataset, tmp_path):
    """(JAX node-class trainer with its seed-0 backbone and head, the head's
    (JAX tree, optimizer state), the port's trainer holding the same), both
    under scan_epochs with head dropout 0."""
    import jax

    from dyglib_tpu.data import get_link_prediction_data as jax_link_data
    from dyglib_tpu.data import get_node_classification_data as jax_nc_data
    from dyglib_tpu.train import TrainConfig as JaxConfig
    from dyglib_tpu.train.node_classification import NodeClassificationTrainer as JaxTrainer

    jlink = jax_link_data("synthetic", data_root=synthetic_dataset)
    plink = get_link_prediction_data("synthetic", data_root=synthetic_dataset)
    cfg = dict(batch_size=B, learning_rate=1e-3, head_dropout=0.0, scan_epochs=True)
    jb = _jax_backbone(name, jlink)
    jtr = JaxTrainer(jb, jax_nc_data("synthetic", data_root=synthetic_dataset),
                     JaxConfig(**cfg), str(tmp_path / "j.pkl"), None)
    jtr.backbone_params = jax.jit(jb.init)(jax.random.PRNGKey(0), jtr.tables, jtr.full_csr)
    tr = NodeClassificationTrainer(
        _port_backbone(name, plink), get_node_classification_data(
            "synthetic", data_root=synthetic_dataset), TrainConfig(**cfg),
        str(tmp_path / "p.pkl"),
        module_state_dict(jax.tree_util.tree_map(np.asarray, jtr.backbone_params)),
        device="cpu")
    head, opt_state = jtr.init_params(0)
    tr.init_params(0)
    tr.load_head(module_state_dict(jax.tree_util.tree_map(np.asarray, head)))
    return jtr, (head, opt_state), tr


@pytest.mark.parametrize("name", ["TGAT", "TGN"])
def test_node_classification_scan_matches_jax(synthetic_dataset, tmp_path, name):
    import jax

    jtr, (head, opt_state), tr = _nc_pair(name, synthetic_dataset, tmp_path)
    _, stacked, labels, keys = jtr._stacked_batches(jtr.data.train, jax.random.PRNGKey(0))
    head, _, jstate, jlosses = jtr.train_scan_fn(head, opt_state, jtr.init_state(),
                                                 jtr.full_csr, stacked, labels, keys)
    losses, state = tr.train_epoch_scanned()
    np.testing.assert_allclose(losses, np.asarray(jlosses), atol=1e-5, rtol=0)
    if name == "TGN":
        _assert_state_close(state, jstate, 1e-5, "after the head epoch")
    jprobs, probs = [], []
    eval_scan = jtr.eval_scan_fn

    def record_jax(*a):
        p, st = eval_scan(*a)
        jprobs.append(np.asarray(p))
        return p, st

    jtr.eval_scan_fn = record_jax
    jm, _ = jtr.evaluate(head, jtr.data.val, state=jstate, salt=0)
    scan = tr.graphs.scan

    def record_port(*a, **kw):
        out = scan(*a, **kw)
        probs.append(out[0][0].numpy())
        return out

    tr.graphs.scan = record_port
    m, _ = tr.evaluate(tr.data.val, state=state, salt=0)
    assert len(probs) == len(jprobs) == 1 and probs[0].shape == jprobs[0].shape
    np.testing.assert_allclose(probs[0], jprobs[0], atol=1e-5, rtol=0)
    assert abs(m["roc_auc"] - jm["roc_auc"]) <= 1e-6


def test_node_classification_scan_needs_uniform_batches(synthetic_dataset, tmp_path,
                                                       monkeypatch):
    """The JAX ``_stacked_batches`` assertion: a scan stacks full batches."""
    from dyglib_tpu_torch.train import node_classification

    tr = _nc_pair("TGAT", synthetic_dataset, tmp_path)[2]
    batches, stacked = tr._stacked_batches(tr.data.val)
    assert [x.shape for x in stacked] == [(len(batches), B)] * 6
    assert stacked[4].sum() == tr.data.val.num_interactions  # valid: the padded rows are 0
    full = node_classification.chronological_batches

    def ragged(stream, batch_size):
        for b in full(stream, batch_size):
            yield dataclasses.replace(b, src=b.src[:-1])

    monkeypatch.setattr(node_classification, "chronological_batches", ragged)
    with pytest.raises(ValueError, match="uniform"):
        tr._stacked_batches(tr.data.val)


# --------------------------------------------------------- scan vs the loop
def _generator_states(tr):
    return [g.get_state() for g in (tr.dropout_gen, tr.sample_gen, tr._eval_gen)
            if g is not None]


@pytest.mark.parametrize("name,kw", [
    ("TGAT", dict(sample_strategy="uniform")), ("TGN", {}), ("DyGFormer", {}),
], ids=["TGAT-uniform", "TGN", "DyGFormer"])
def test_scan_equals_the_loop_on_the_cpu(port_data, name, kw):
    """Dropout 0.1: the staged sweep draws what the loop draws, in order."""
    out = {}
    for scanned in (False, True):
        tr = LinkPredictionTrainer(_port_backbone(name, port_data, dropout=0.1, **kw),
                                   _short(port_data),
                                   TrainConfig(batch_size=B, learning_rate=1e-3,
                                               sequence_buckets=False), device="cpu")
        tr.init_params(3)
        tr.train_neg = NegativeEdgeSampler(tr.data.train.src, tr.data.train.dst, seed=42)
        train = (tr.train_epoch_scanned if scanned else tr.train_epoch)()
        state = train[2] if tr.has_state else None
        ev = tr.evaluate(port_data.val, tr.val_neg, 1, state=state, scanned=scanned)
        out[scanned] = (train, ev, tr.state_dicts(), _generator_states(tr))
    (t0, e0, p0, g0), (t1, e1, p1, g1) = out[False], out[True]
    assert t0[0] == t1[0] and e0[0] == e1[0]
    for (a, b), (c, d) in zip(e0[2], e1[2]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    for part in p0:
        for k in p0[part]:
            torch.testing.assert_close(p0[part][k], p1[part][k], rtol=0, atol=0)
    if name == "TGN":
        for s0, s1 in ((t0[2], t1[2]), (e0[3], e1[3])):
            for f in MemoryState._fields:
                torch.testing.assert_close(getattr(s0, f), getattr(s1, f), rtol=0, atol=0)
    assert len(g0) == len(g1) == (3 if name == "TGAT" else 1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_node_classification_scan_equals_the_loop_on_the_cpu(synthetic_dataset):
    pd = get_link_prediction_data("synthetic", data_root=synthetic_dataset)
    nc = get_node_classification_data("synthetic", data_root=synthetic_dataset)
    backbone = _port_backbone("TGN", pd)
    net = backbone.build(nc.node_raw_features.shape[1], nc.edge_raw_features.shape[1],
                         torch.Generator().manual_seed(0))
    out = {}
    for scanned in (False, True):
        tr = NodeClassificationTrainer(backbone, nc, TrainConfig(batch_size=B), None,
                                       net.state_dict(), device="cpu")
        tr.init_params(1)
        losses, state = (tr.train_epoch_scanned if scanned else tr.train_epoch)()
        m, _ = tr.evaluate(nc.val, state=state, scanned=scanned)
        out[scanned] = (losses, state, m, tr.head.state_dict(), tr.dropout_gen.get_state())
    (l0, s0, m0, h0, g0), (l1, s1, m1, h1, g1) = out[False], out[True]
    assert l0 == l1 and m0 == m1 and torch.equal(g0, g1)
    for k in h0:
        torch.testing.assert_close(h0[k], h1[k], rtol=0, atol=0)
    for f in MemoryState._fields:
        torch.testing.assert_close(getattr(s0, f), getattr(s1, f), rtol=0, atol=0)


# ---------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_data():
    return synthetic_link_prediction_data(num_src=120, num_dst=60, num_edges=2000,
                                          node_feat_scale=1.0, seed=7)


def _card_trainer(name, d, card, **kw):
    tr = LinkPredictionTrainer(_port_backbone(name, d, **kw), d,
                               TrainConfig(batch_size=B, learning_rate=1e-3, scan_epochs=True,
                                           sequence_buckets=False), device=card)
    tr.init_params(0)
    return tr


def _snapshot(tr):
    """Parameters, optimizer state and generators, copied (restored in place
    by ``_restore``, so a captured graph stays valid)."""
    opt = [{k: v.clone() for k, v in s.items()} for s in tr.optimizer.state.values()]
    params = [p.detach().clone() for m in (tr.model, tr.head) for p in m.parameters()]
    return params, opt, _generator_states(tr)


def _restore(tr, snap):
    params, opt, gens = snap
    with torch.no_grad():
        for p, v in zip((p for m in (tr.model, tr.head) for p in m.parameters()), params):
            p.copy_(v)
        for s, v in zip(tr.optimizer.state.values(), opt):
            for k in s:
                s[k].copy_(v[k])
    for g, st in zip((g for g in (tr.dropout_gen, tr.sample_gen, tr._eval_gen)
                      if g is not None), gens):
        g.set_state(st)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [
    ("TGAT", {}), ("TGAT", dict(sample_strategy="uniform")), ("TGN", {}), ("DyGFormer", {}),
], ids=["TGAT", "TGAT-uniform", "TGN", "DyGFormer"])
def test_captured_epoch_matches_eager_on_the_card(card, card_data, name, kw):
    tr = _card_trainer(name, card_data, card, dropout=0.1, **kw)
    tr.train_neg = NegativeEdgeSampler(card_data.train.src, card_data.train.dst, seed=42)
    tr.train_epoch()  # the optimizer's state exists before the snapshot
    snap = _snapshot(tr)
    runs = {}
    for captured in (False, True):
        _restore(tr, snap)
        tr.train_neg.reset_random_state()
        ops.reset_launch_counts()
        tr.graphs.reset_counts()
        run = tr.train_epoch_scanned if captured else tr.train_epoch
        train = run()
        state = train[2] if tr.has_state else None
        ev = tr.evaluate(card_data.val, tr.val_neg, 0, state=state, scanned=captured)
        torch.cuda.synchronize()
        launches = {k: v + tr.graphs.launches().get(k, 0)
                    for k, v in ops.launch_counts().items()}
        runs[captured] = (train, ev, [p.detach().clone() for p in tr.model.parameters()],
                          _generator_states(tr), launches)
    (t0, e0, p0, g0, n0), (t1, e1, p1, g1, n1) = runs[False], runs[True]
    assert tr.graphs.replays > 0
    np.testing.assert_allclose(t0[0], t1[0], atol=1e-5)
    np.testing.assert_allclose(e0[0], e1[0], atol=1e-5)
    for (a, b), (c, d) in zip(e0[2], e1[2]):
        np.testing.assert_allclose(a, c, atol=1e-5, rtol=0)
        np.testing.assert_allclose(b, d, atol=1e-5, rtol=0)
    for a, b in zip(p0, p1):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    if name == "TGN":
        for s0, s1 in ((t0[2], t1[2]), (e0[3], e1[3])):
            for f in MemoryState._fields:
                atol = 1e-5 if getattr(s0, f).is_floating_point() else 0
                torch.testing.assert_close(getattr(s0, f), getattr(s1, f), atol=atol, rtol=0)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert n0 == n1 and any(n0.values())


@pytest.mark.cuda
def test_replay_reads_its_static_inputs(card):
    from dyglib_tpu_torch.train.step_graph import StepGraphs

    graphs = StepGraphs(card)
    x = torch.arange(8, dtype=torch.float32, device=card)
    outs = [graphs.run("k", lambda t: (t * 2 + 1,), (x + i,))[0].clone() for i in range(4)]
    torch.cuda.synchronize()
    assert graphs.replays == 3
    for i, o in enumerate(outs):
        torch.testing.assert_close(o, (x + i) * 2 + 1, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["TGN", "DyGFormer"])
def test_captured_head_epoch_matches_eager_on_the_card(card, card_data, name):
    """Node classification: a captured head epoch and sweep against the
    eager ones (head dropout 0.1), from one snapshot of the head, its
    optimizer and the generators."""
    from dyglib_tpu_torch.data import split_node_classification_data

    nc = split_node_classification_data(card_data.full, card_data.edge_raw_features,
                                        card_data.node_raw_features)
    backbone = _port_backbone(name, card_data)
    net = backbone.build(nc.node_raw_features.shape[1], nc.edge_raw_features.shape[1],
                         torch.Generator().manual_seed(0))
    tr = NodeClassificationTrainer(backbone, nc, TrainConfig(batch_size=B, scan_epochs=True),
                                   None, net.state_dict(), device=card)
    tr.init_params(0)
    tr.train_epoch()  # the optimizer's state exists before the snapshot
    head = [p.detach().clone() for p in tr.head.parameters()]
    opt = [{k: v.clone() for k, v in s.items()} for s in tr.optimizer.state.values()]
    gen = tr.dropout_gen.get_state()
    runs = {}
    for captured in (False, True):
        with torch.no_grad():
            for p, v in zip(tr.head.parameters(), head):
                p.copy_(v)
            for s, v in zip(tr.optimizer.state.values(), opt):
                for k in s:
                    s[k].copy_(v[k])
        tr.dropout_gen.set_state(gen)
        losses, state = (tr.train_epoch_scanned if captured else tr.train_epoch)()
        metrics, final = tr.evaluate(nc.val, state=state, scanned=captured)
        torch.cuda.synchronize()
        runs[captured] = (losses, state, metrics, final,
                          [p.detach().clone() for p in tr.head.parameters()],
                          tr.dropout_gen.get_state())
    (l0, s0, m0, f0, h0, g0), (l1, s1, m1, f1, h1, g1) = runs[False], runs[True]
    assert tr.graphs.replays > 0
    np.testing.assert_allclose(l0, l1, atol=1e-5)
    assert abs(m0["roc_auc"] - m1["roc_auc"]) <= 1e-6
    for a, b in zip(h0, h1):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert torch.equal(g0, g1)
    if name == "TGN":
        for st0, st1 in ((s0, s1), (f0, f1)):
            for f in MemoryState._fields:
                atol = 1e-5 if getattr(st0, f).is_floating_point() else 0
                torch.testing.assert_close(getattr(st0, f), getattr(st1, f), atol=atol, rtol=0)


@pytest.mark.cuda
def test_a_capture_counts_its_launches_apart(card):
    """A wrapper called under a capture counts in ``captured``, not in
    ``launches``: the capture records the launch, each replay runs it."""
    from dyglib_tpu_torch.train.step_graph import StepGraphs

    graphs = StepGraphs(card)
    ids = torch.randint(0, 9, (64, 16), dtype=torch.int32, device=card)
    ops.reset_launch_counts()
    for _ in range(4):
        graphs.run("k", lambda q: (ops.cooccurrence_counts(q, q),), (ids,))
    torch.cuda.synchronize()
    assert ops.launch_counts()["cooccurrence"] == 1  # the warm-up step
    assert ops.captured_counts()["cooccurrence"] == 1
    assert graphs.replays == 3 and graphs.launches() == {"cooccurrence": 3}


@pytest.mark.cuda
def test_captured_evaluates_with_other_salts_replay_one_graph(card, card_data):
    """A stochastic strategy's eval graph is cached once and its registered
    generator re-seeded a sweep: sweeps with salts 0, 2 and 0 through it
    draw what eager sweeps with those salts draw."""
    tr = _card_trainer("TGAT", card_data, card, sample_strategy="uniform")

    def sweep(salt, scanned):
        probs = tr.evaluate(card_data.val, tr.val_neg, salt, scanned=scanned)[2]
        return probs, tr._eval_gen.get_state()

    eager = {salt: sweep(salt, False) for salt in (0, 2)}
    assert not np.array_equal(eager[0][0][0][0], eager[2][0][0][0])  # salts draw apart
    for i, salt in enumerate((0, 2, 0)):
        tr.graphs.reset_counts()
        probs, gen = sweep(salt, True)
        assert tr.graphs.replays == len(probs) - (i == 0)  # the first sweep's warm-up
        for (a, b), (c, d) in zip(probs, eager[salt][0]):
            np.testing.assert_allclose(a, c, atol=1e-5, rtol=0)
            np.testing.assert_allclose(b, d, atol=1e-5, rtol=0)
        assert torch.equal(gen, eager[salt][1])
    assert [k[0] for k in tr.graphs._entries] == ["eval"]


def _loop_steps(tr):
    """Make a scan-mode trainer's ``fit`` take the loop's steps (its train
    epochs and sweeps batch by batch) while keeping the scan mode's
    ``capturable`` Adam, whose f32 arithmetic differs from the default
    Adam's in the last bits."""
    evaluate = tr.evaluate
    tr.train_epoch_scanned = lambda state=None, epoch=0: tr.train_epoch(state=state,
                                                                         epoch=epoch)
    tr.evaluate = lambda *a, **kw: evaluate(*a, **{**kw, "scanned": False})


@pytest.mark.cuda
def test_scanned_fit_matches_the_loop_fit_on_the_card(card, card_data, tmp_path):
    """``fit`` with ``scan_epochs`` (train epochs and the val, new-node val,
    test and new-node test sweeps replayed, one eval graph for salts 0-3)
    against the same ``fit`` on the loop's steps, TGAT ``uniform`` at
    dropout 0.1."""
    res, replays = {}, {}
    for scanned in (False, True):
        tr = LinkPredictionTrainer(
            _port_backbone("TGAT", card_data, dropout=0.1, sample_strategy="uniform"),
            card_data, TrainConfig(batch_size=B, num_epochs=2, learning_rate=1e-3,
                                   scan_epochs=True),
            save_path=str(tmp_path / f"{scanned}.pkl"), device=card)
        tr.train_neg = NegativeEdgeSampler(card_data.train.src, card_data.train.dst, seed=42)
        if not scanned:
            _loop_steps(tr)
        res[scanned] = tr.fit(seed=0, log=lambda *a: None)
        replays[scanned] = tr.graphs.replays
    loop, graph = res[False], res[True]
    assert replays[False] == 0 and replays[True] > 0 and len(loop["train losses"]) == 2
    np.testing.assert_allclose(loop["train losses"], graph["train losses"], atol=1e-5)
    for key in ("validate metrics", "new node validate metrics", "test metrics",
                "new node test metrics"):
        assert set(loop[key]) == set(graph[key])
        for k in loop[key]:
            assert abs(loop[key][k] - graph[key][k]) <= 1e-5, (key, k)
    for part, sd in loop["params"].items():
        for k, v in sd.items():
            torch.testing.assert_close(graph["params"][part][k], v, atol=1e-5, rtol=0)
