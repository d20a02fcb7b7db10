"""TGAT under ``time_interval_aware`` sampling, the port against the JAX
package on the CPU.

The port draws its uniforms and fallback offsets from a
``torch.Generator``, the JAX package from ``fold_in(key, h)`` at hop h:
the draws agree only in distribution. So every parity check hands the port
JAX's randomness: ``sampler._tia_indices`` is replaced, for the test, by
``tia_select`` on the u and r that the JAX sampler draws from the same
key at the same hop. With them:

  * ``TGAT.sample``'s hop tensors are bitwise equal to the JAX
    ``TGAT.sample`` at hops 0 and 1, on the CSR as built and with the
    weights of some nodes' segments planted at zero, so that hop 1 reaches
    the uniform fallback of windows whose total weight is not positive;
  * the TGATNet forward (plain path, and the default kernels' plain
    versions) on them within 1e-5 of the JAX plain f32 net, as
    ``test_torch_tgat.py::test_tgatnet_matches_jax_plain`` holds recent's;
  * one train step on the JAX test fixture: the loss within 1e-4 and every
    gradient within 1e-3 of its tensor's largest entry, against
    ``jax.value_and_grad`` of the JAX trainer's loss on the same batch and
    parameters (dropout 0);
  * the port's own draws at hop 1 follow the softmax of each window's
    logits (chi-square, p > 1e-3, for windows of three sizes; uniform
    draws would fail it);
  * the trainers on the CPU: a train step, two ``evaluate`` sweeps with
    equal probabilities, a scanned epoch equal to the loop's, a
    node-classification head step on the frozen backbone, and the
    link-prediction and node-classification drivers for one epoch.

Small widths (Dn = De = 12, Dt = 10, K = 4, L = 2, B = 16), the JAX
fixture's 172-wide features for the trainer checks.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.graph import build_temporal_csr as jax_build_csr
from dyglib_tpu.models import FeatureTables as JaxTables
from dyglib_tpu.models import TGAT as JaxTGAT
from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer
from dyglib_tpu.train import TrainConfig as JaxConfig
from dyglib_tpu_torch import runners
from dyglib_tpu_torch.cli import train_link_prediction, train_node_classification
from dyglib_tpu_torch.data import (
    chronological_batches,
    get_link_prediction_data,
    get_node_classification_data,
    synthetic_link_prediction_data,
)
from dyglib_tpu_torch.graph import (
    NegativeEdgeSampler,
    build_temporal_csr,
    sample_multi_hop,
    window_bounds,
)
from dyglib_tpu_torch.graph import sampler
from dyglib_tpu_torch.models import TGAT, FeatureTables
from dyglib_tpu_torch.train import (
    LinkPredictionTrainer,
    NodeClassificationTrainer,
    TrainConfig,
)
from dyglib_tpu_torch.transfer import module_state_dict
from tests.torch_parity import assert_grads_match, jax_grads, jax_params, port_grads, port_trainer

TIA = "time_interval_aware"
FEAT, DT, K, L, B = 12, 10, 4, 2, 16
# the trainers' time_scaling_factor (TrainConfig's default in both packages)
ALPHA = 1e-6
LR, TRAIN_B = 1e-4, 200
CONFIGS = {
    "plain_path": dict(use_fused_attention=False, use_gathered_attention=False),
    "default": {},
}
JAX_PLAIN = dict(
    compute_dtype="float32", use_fused_attention=False, use_window_attention=False,
    use_gathered_attention=False, use_phi_fusion=False,
)


def use_jax_draws(monkeypatch, key, num_hops=L) -> list:
    """Make the port's time_interval_aware draws the JAX sampler's: at hop
    h of each multi-hop sample, the uniforms u and fallback offsets r that
    JAX's ``_tia_indices`` draws from ``fold_in(key, h)``. Returns the list
    of hops drawn so far."""
    hops = []

    def draws(csr, lo, hi, k, gen):
        h = len(hops) % num_hops
        hops.append(h)
        key_u, key_f = jax.random.split(jax.random.fold_in(key, h))
        shape = tuple(lo.shape) + (k,)
        cnt = jnp.maximum(jnp.asarray((hi - lo).numpy()), 1)
        u = np.array(jax.random.uniform(key_u, shape))
        r = np.array(jax.random.randint(key_f, shape, 0, cnt[..., None]))
        return sampler.tia_select(csr, lo, hi, torch.from_numpy(u), torch.from_numpy(r))

    monkeypatch.setattr(sampler, "_tia_indices", draws)
    return hops


@pytest.fixture(scope="module")
def small():
    """The 1500-edge stream at FEAT-wide features, both packages' CSRs with
    their time_interval_aware weights, and B queries (val endpoints, a
    node with no history yet, the padding id 0)."""
    data = synthetic_link_prediction_data(
        num_src=60, num_dst=30, num_edges=1500, edge_feat_dim=FEAT, node_feat_scale=1.0, seed=3
    )
    data = dataclasses.replace(
        data,
        node_raw_features=np.ascontiguousarray(data.node_raw_features[:, :FEAT]),
        edge_raw_features=np.ascontiguousarray(data.edge_raw_features[:, :FEAT]),
    )
    kw = dict(num_nodes=data.num_nodes, with_tia=True, time_scaling_factor=ALPHA)
    jax_csr = jax_build_csr(data.full, **kw)
    csr = build_temporal_csr(data.full, **kw)
    rng = np.random.RandomState(0)
    pick = rng.choice(data.val.num_interactions, B - 2, replace=False)
    ids = np.concatenate([data.val.src[pick[: B // 2]], data.val.dst[pick[B // 2 :]],
                          [data.full.src[0], 0]]).astype(np.int32)
    ts = np.concatenate([data.val.ts[pick], [data.full.ts[0], data.full.ts[-1]]]).astype(np.int32)
    return data, jax_csr, csr, ids, ts


def _plant_zero_weights(jax_csr, csr, nodes):
    """Both CSRs with the weights of ``nodes``' segments set to zero."""
    cew = csr.tia_cew.clone()
    offsets = csr.offsets.numpy()
    for n in nodes:
        cew[offsets[n]:offsets[n + 1]] = 0.0
    return (jax_csr._replace(tia_cew=jnp.asarray(cew.numpy())),
            dataclasses.replace(csr, tia_cew=cew))


@pytest.mark.parametrize("weights", ["as_built", "zero_weight_segments"])
def test_sample_matches_jax_bitwise(small, monkeypatch, weights):
    _, jax_csr, csr, ids, ts = small
    key = jax.random.PRNGKey(5)
    jax_tgat = JaxTGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT, sample_strategy=TIA)
    jids, jts = jnp.asarray(ids), jnp.asarray(ts)
    planted = set()
    if weights == "zero_weight_segments":
        # every other node that hop 0 draws: their hop-1 windows weigh 0
        drawn = np.asarray(jax_tgat.sample(jax_csr, jids, jts, key).hop_ids[1]).ravel()
        planted = set(np.unique(drawn[drawn > 0])[::2].tolist())
        jax_csr, csr = _plant_zero_weights(jax_csr, csr, planted)
    ref = jax_tgat.sample(jax_csr, jids, jts, key)
    hops = use_jax_draws(monkeypatch, key)
    tgat = TGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT, sample_strategy=TIA)
    ours = tgat.sample(csr, torch.from_numpy(ids), torch.from_numpy(ts), gen=torch.Generator())
    assert hops == list(range(L))
    for f in ("hop_ids", "hop_eids", "hop_ts", "hop_mask"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert len(a) == len(b), f
        for h, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f"{f} {h}")
    assert ours.hop_win_start is None and ref.hop_win_start is None
    assert ours.hop_node_feat is None and ours.feat_table is None
    # hop 1 draws real rows, and (planted) from windows that weigh nothing
    rows = ours.hop_mask[1].reshape(-1, K).all(-1)
    queries = ours.hop_ids[1].reshape(-1)
    assert rows.any() and not ours.hop_mask[0][-1].any()  # id 0 has no history
    if planted:
        assert any(int(q) in planted for q in queries[rows])


@pytest.fixture(scope="module")
def jax_reference(small):
    """The JAX plain f32 TGATNet's parameters, the key of its draws, and its
    embeddings of the queries."""
    data, jax_csr, _, ids, ts = small
    tables = JaxTables(node=jnp.asarray(data.node_raw_features),
                       edge=jnp.asarray(data.edge_raw_features))
    tgat = JaxTGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT, sample_strategy=TIA,
                   **JAX_PLAIN)
    key = jax.random.PRNGKey(9)
    params = jax.jit(tgat.init)(jax.random.PRNGKey(1), tables, jax_csr)
    inputs = jax.jit(tgat.sample)(jax_csr, jnp.asarray(ids), jnp.asarray(ts), key)
    emb = jax.jit(tgat.apply)(params, tables, inputs)
    return jax.tree_util.tree_map(np.asarray, params), key, np.asarray(emb)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_tgatnet_matches_jax_plain(small, jax_reference, monkeypatch, config):
    data, _, csr, ids, ts = small
    params, key, ref = jax_reference
    tgat = TGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT, sample_strategy=TIA,
                **CONFIGS[config])
    assert (tgat._gathered_kernel, tgat._fused_attention, tgat._window_kernel) == (
        (True, True, False) if config == "default" else (False, False, False))
    net = tgat.build(FEAT, FEAT, torch.Generator().manual_seed(0)).eval()
    net.load_state_dict(module_state_dict(params))
    tables = FeatureTables(node=torch.from_numpy(data.node_raw_features),
                           edge=torch.from_numpy(data.edge_raw_features))
    use_jax_draws(monkeypatch, key)
    inputs = tgat.sample(csr, torch.from_numpy(ids), torch.from_numpy(ts), gen=torch.Generator())
    with torch.no_grad():
        emb = net(tables, inputs)
    assert emb.shape == (B, FEAT) and torch.isfinite(emb).all()
    np.testing.assert_allclose(emb.numpy(), ref, atol=1e-5)


@pytest.fixture(scope="module")
def port_data(synthetic_dataset):
    return get_link_prediction_data("synthetic", data_root=synthetic_dataset)


@pytest.fixture(scope="module")
def jax_step(link_data, port_data, tmp_path_factory):
    """The JAX trainer's plain f32 TGAT under time_interval_aware (dropout
    0), its seed-0 parameters, and its loss and gradients on train batch 2
    with seeded negatives; the key whose sample half drew the neighbors."""
    jtr = JaxTrainer(
        JaxTGAT(num_neighbors=K, num_layers=L, dropout=0.0, sample_strategy=TIA, **JAX_PLAIN),
        link_data, JaxConfig(batch_size=TRAIN_B, learning_rate=LR),
        str(tmp_path_factory.mktemp("jax") / "unused.pkl"))
    assert jtr.train_csr.tia_cew is not None
    params = jax_params(jtr)
    rng = np.random.RandomState(5)
    for i, b in enumerate(chronological_batches(port_data.train, TRAIN_B)):
        neg = rng.choice(np.unique(port_data.train.dst), size=len(b.src))
        if i == 2:
            break
    jarrays = jtr._batch_arrays(b, b.src, neg)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        return jtr._forward(p, jtr.train_csr, jtr.tables, jarrays, key, True, None, False,
                            None)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params))
    # _forward samples with the first half of its key
    return params, float(loss), jax_grads(grads), (b, neg), jax.random.split(key)[0]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_train_step_matches_jax_grad(jax_step, port_data, monkeypatch, config):
    params, jloss, want, (b, neg), sample_key = jax_step
    tr = port_trainer(
        TGAT(num_neighbors=K, num_layers=L, dropout=0.0, sample_strategy=TIA, **CONFIGS[config]),
        port_data, params, batch_size=TRAIN_B, learning_rate=LR)
    assert tr.train_csr.tia_cew is not None and tr._layout() == "dedup"
    hops = use_jax_draws(monkeypatch, sample_key)
    loss, _ = tr.train_step(tr._batch_arrays(b, b.src, neg))
    assert hops == list(range(L))
    assert abs(float(loss) - jloss) <= 1e-4, (float(loss), jloss)
    assert_grads_match(port_grads(tr), want, rtol=1e-3)


def test_hop1_draws_follow_the_window_softmax(small):
    """The busiest node, 1000 times at one time, K = 20: its hop-0 draws are
    the hop-1 queries; for three of their windows (sizes near 3, 10 and 30,
    each drawn for at least 80 rows of K),
    the counts of the port's own hop-1 draws over the window's entries
    pass a chi-square test against softmax(v), v_i = exp(a dt_i) /
    sum_{j<=i} exp(a dt_j) over the window (the reference's logits), and
    fail one against uniform draws."""
    from scipy.stats import chisquare

    data, _, csr, _, _ = small
    deg = np.diff(csr.offsets.numpy())
    node = int(np.argmax(deg))
    reps, k = 1000, 20
    t_end = int(data.full.ts[-1]) + 1
    blocks = sample_multi_hop(csr, torch.full((reps,), node, dtype=torch.int32),
                              torch.full((reps,), t_end, dtype=torch.int32), k, 2, TIA,
                              gen=torch.Generator().manual_seed(11))
    assert blocks[0].mask.all()
    q_nbr, q_ts = blocks[0].nbr.reshape(-1), blocks[0].ts.reshape(-1)
    hop1_eid = blocks[1].eid.reshape(-1, k)
    hop1_ok = blocks[1].mask.reshape(-1, k).all(-1)
    keys, inverse = np.unique(np.stack([q_nbr.numpy(), q_ts.numpy()], 1), axis=0,
                              return_inverse=True)
    inverse = inverse.reshape(-1)
    lo, hi = window_bounds(csr, torch.from_numpy(keys[:, 0]), torch.from_numpy(keys[:, 1]))
    sizes = (hi - lo).numpy()
    rows = np.bincount(inverse, minlength=len(keys))
    picks = set()
    for want in (3, 10, 30):
        ok = np.nonzero((sizes >= 2) & (rows >= 80))[0]
        picks.add(int(ok[np.argmin(np.abs(sizes[ok] - want))]))
    ts_all = csr.ts.numpy().astype(np.float64)
    for g in sorted(picks):
        n = int(sizes[g])
        window = csr.eid[lo[g]:hi[g]].tolist()
        assert len(set(window)) == n
        sel = torch.from_numpy(inverse == g)
        assert hop1_ok[sel].all()
        pos = {e: i for i, e in enumerate(window)}
        counts = np.bincount([pos[e] for e in hop1_eid[sel].reshape(-1).tolist()], minlength=n)
        seg_ts = ts_all[lo[g]:hi[g]]
        ew = np.exp(ALPHA * (seg_ts - seg_ts.max()))
        v = ew / np.cumsum(ew)
        p = np.exp(v - v.max())
        p /= p.sum()
        assert chisquare(counts, p * counts.sum()).pvalue > 1e-3, (n, counts, p)
        if n >= 10:
            assert chisquare(counts).pvalue < 1e-3, (n, counts)


def test_trainer_steps_and_repeatable_evaluate(small):
    data, *_ = small
    tr = LinkPredictionTrainer(
        TGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT, sample_strategy=TIA), data,
        TrainConfig(batch_size=100), device="cpu")
    tr.init_params(0)
    assert tr.train_csr.tia_cew is not None and tr.full_csr.tia_cew is not None
    assert tr.train_csr.feat_entry is None and tr.sample_gen is not None
    _, arrays, bucket = next(iter(tr.train_batches()))
    loss, (pos, _) = tr.train_step(arrays, bucket)
    assert bucket is None and torch.isfinite(loss) and pos.shape == (100,)
    for mod in (tr.model, tr.head):
        for name, p in mod.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
    stream = data.val.slice(0, 300)
    first, second = (tr.evaluate(stream, tr.val_neg)[2] for _ in range(2))
    salted = tr.evaluate(stream, tr.val_neg, eval_key_salt=1)[2]
    assert len(first) == 3
    for (p1, n1), (p2, n2) in zip(first, second):
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(n1, n2)
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(first, salted))


def test_scanned_epoch_equals_the_loop(small):
    """On the CPU the scan path's staged loop runs eagerly: from the same
    seed (parameters and the sampling generator) and seeded negatives,
    its losses and final parameters equal the loop's."""
    data, *_ = small
    tr = LinkPredictionTrainer(
        TGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT, sample_strategy=TIA, dropout=0.0),
        data, TrainConfig(batch_size=100, scan_epochs=True), device="cpu")
    tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=3)
    stream = data.train.slice(0, 400)
    runs = []
    for epoch in (tr.train_epoch, tr.train_epoch_scanned):
        tr.init_params(0)
        tr.train_neg.reset_random_state()
        losses = epoch(stream)[0]
        runs.append((np.asarray(losses), [p.detach().clone() for p in tr.model.parameters()]))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert len(runs[0][0]) == 4
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_node_classification_head_step_on_a_frozen_backbone(synthetic_dataset):
    nc = get_node_classification_data("synthetic", data_root=synthetic_dataset)
    backbone = TGAT(num_neighbors=K, num_layers=L, sample_strategy=TIA)
    params = backbone.build(nc.node_raw_features.shape[1], nc.edge_raw_features.shape[1],
                            torch.Generator().manual_seed(0)).state_dict()
    tr = NodeClassificationTrainer(backbone, nc, TrainConfig(batch_size=128), None, params,
                                   device="cpu")
    tr.init_params(0)
    assert tr.full_csr.tia_cew is not None and tr.sample_gen is not None
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    b = next(iter(chronological_batches(nc.train, 128)))
    loss, probs, _ = tr.train_step(tr._batch_arrays(b),
                                   torch.from_numpy(b.label.astype(np.float32)))
    assert torch.isfinite(loss) and probs.shape == (128,)
    assert all(p.grad is not None for p in tr.head.parameters())
    assert all(p.grad is None for p in tr.model.parameters())
    assert all(torch.equal(v, before[k]) for k, v in tr.model.state_dict().items())
    stream = nc.val.slice(0, 256)
    first, second = (tr.evaluate(stream)[0] for _ in range(2))
    assert first == second and 0.0 <= first["roc_auc"] <= 1.0


def test_drivers_train_one_epoch_under_the_strategy(synthetic_dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    built = []

    def spy(args, data):
        built.append(runners_build(args, data))
        return built[-1]

    runners_build = runners.build_backbone
    monkeypatch.setattr(runners, "build_backbone", spy)
    argv = ["--model_name", "TGAT", "--dataset_name", "synthetic", "--data_root",
            synthetic_dataset, "--num_runs", "1", "--num_epochs", "1", "--num_neighbors", "4",
            "--num_layers", "1", "--sample_neighbor_strategy", TIA, "--device", "cpu"]
    for driver in (train_link_prediction, train_node_classification):
        aggregate = driver.main(argv)
        values = [mean for split in aggregate.values() for mean, _ in split.values()]
        assert values and all(0.0 <= v <= 1.0 for v in values)
    assert len(built) == 2 and all(b.sample_strategy == TIA for b in built)
    results = "saved_results/TGAT/synthetic"
    assert set(os.listdir(results)) == {"TGAT_seed0.json", "node_classification_TGAT_seed0.json"}
    assert "test metrics" in json.load(open(f"{results}/TGAT_seed0.json"))
