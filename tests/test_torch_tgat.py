"""TGAT in the port against the JAX package on the CPU.

  * the CSR's next-hop bounds ``nbr_hi``, multi-hop ``recent`` sampling
    with its windows, the entry-window fetch and ``TGAT.sample`` are
    integer or copied data: bitwise equal;
  * the port's TGATNet in each configuration (plain path, default kernels
    (gathered at layer 1, fused at layer 2) with and without the entry
    table, window kernel, Phi fusion), with the JAX parameters carried by
    ``from_jax_params``, is held to the JAX package's plain f32 TGATNet
    within 1e-5 (the kernel branches compute the same math in another
    order of f32 sums);
  * the trainer's ``evaluate`` probabilities on the test fixture, per
    configuration, within 1e-5 of the JAX trainer's (its random-negative
    protocol embeds the dedup triple [src || dst || neg_dst], as the port's
    does);
  * training: with dropout 0, one train step's parameter gradients in each
    configuration against ``jax.grad`` of the JAX trainer's loss (its plain
    f32 path, the same injected batch and parameters) within 2e-5 of each
    tensor's largest entry (f32 on both sides, sums in other orders). Phi
    fusion computes key = feat @ Wk[:Df] + Phi @ Wk[Df:], another
    association than JAX's concatenation: its last-bit differences flip a
    few of layer 1's ReLUs and move the cancelling time-encoder sums (dt up
    to ~1e6), so at the JAX initialization its gradients are held to 1e-3
    of each tensor's largest entry or 5e-4 of the net's largest gradient
    entry, whichever is larger (measured: 3.1e-3 and 7.6e-5 at most,
    merge_0.fc1; the same in autograd of the plain Phi-fusion forward, and
    in float64 the two associations agree to 5e-15); a
    3-step Adam trajectory in the default configuration (losses within
    1e-5, then 1e-4; parameters within 6 lr, for the reason
    tests/test_torch_train.py gives); a 1-epoch ``fit``;
  * ``uniform`` sampling: the same window bounds and validity as the JAX
    sampler, every draw inside its window, rows sorted, hop 2 drawn from
    hop 1's draws, a chi-square test of uniformity, seeded repeatability
    and repeatable ``evaluate`` sweeps (the generator's bits differ from
    JAX's keys, so draws are compared in distribution only).

Small widths (Dn = De = 12, Dt = 10, K = 5, L = 2, B = 16) except the
fixture's 172-wide features, at K = 5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.graph import build_temporal_csr as jax_build_csr
from dyglib_tpu.graph.sampler import fetch_entry_windows as jax_fetch_entry_windows
from dyglib_tpu.graph.sampler import sample_multi_hop as jax_sample_multi_hop
from dyglib_tpu.graph.sampler import sample_recent as jax_sample_recent
from dyglib_tpu.graph.sampler import window_bounds as jax_window_bounds
from dyglib_tpu.models import FeatureTables as JaxTables
from dyglib_tpu.models import TGAT as JaxTGAT
from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer
from dyglib_tpu.train import TrainConfig as JaxConfig
from dyglib_tpu_torch import ops
from dyglib_tpu_torch.data import (
    chronological_batches,
    get_link_prediction_data,
    synthetic_link_prediction_data,
)
from dyglib_tpu_torch.graph import (
    build_temporal_csr,
    fetch_entry_windows,
    sample_multi_hop,
    sample_recent,
    sample_uniform,
    window_bounds,
)
from dyglib_tpu_torch.models import TGAT, FeatureTables
from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig
from dyglib_tpu_torch.transfer import from_jax_params, module_state_dict

FEAT, DT, K, L, B = 12, 10, 5, 2, 16
LR, TRAIN_B = 1e-4, 200
# the port's configurations: (TGAT kwargs, whether the CSR holds the entry table)
CONFIGS = {
    "plain_path": (dict(use_fused_attention=False, use_gathered_attention=False), False),
    "default": ({}, False),
    "default_entry_table": ({}, True),
    "window": (dict(wants_entry_features=True), True),
    "phi_fusion": (dict(use_gathered_attention=False, use_phi_fusion=True), False),
    # the flag alone, the other layer-1 flags at "auto"
    "phi_fusion_explicit": (dict(use_phi_fusion=True), False),
}
# the kernels each configuration's net calls (their plain versions on the CPU)
CONFIG_KERNELS = {
    "plain_path": set(),
    "default": {"gathered_attention", "temporal_attention"},
    "default_entry_table": {"gathered_attention", "temporal_attention"},
    "window": {"window_attention", "temporal_attention"},
    "phi_fusion": {"phi_projection"},
    "phi_fusion_explicit": {"phi_projection"},
}
JAX_PLAIN = dict(
    compute_dtype="float32", use_fused_attention=False, use_window_attention=False,
    use_gathered_attention=False, use_phi_fusion=False,
)


@pytest.fixture(scope="module")
def small():
    data = synthetic_link_prediction_data(
        num_src=60, num_dst=30, num_edges=1500, edge_feat_dim=FEAT, node_feat_scale=1.0, seed=3
    )
    # the loader pads features to 172 columns; keep the FEAT real ones
    data = dataclasses.replace(
        data,
        node_raw_features=np.ascontiguousarray(data.node_raw_features[:, :FEAT]),
        edge_raw_features=np.ascontiguousarray(data.edge_raw_features[:, :FEAT]),
    )
    feats = (data.node_raw_features, data.edge_raw_features)
    kw = dict(num_nodes=data.num_nodes, feat_entry_of=feats)
    jax_csr = jax_build_csr(data.full, feat_entry_layout="packed", **kw)
    csr = build_temporal_csr(data.full, **kw)
    plain_csr = build_temporal_csr(data.full, num_nodes=data.num_nodes)
    # queries: val edges' endpoints at their times, a node with no history
    # yet (the first edge's src at its own time) and the padding id 0
    rng = np.random.RandomState(0)
    pick = rng.choice(data.val.num_interactions, B - 2, replace=False)
    ids = np.concatenate([data.val.src[pick[: B // 2]], data.val.dst[pick[B // 2 :]],
                          [data.full.src[0], 0]]).astype(np.int32)
    ts = np.concatenate([data.val.ts[pick], [data.full.ts[0], data.full.ts[-1]]]).astype(np.int32)
    return data, jax_csr, csr, plain_csr, ids, ts


@pytest.mark.parametrize("split", ["train", "full"])
def test_nbr_hi_bitwise_equal(link_data, split):
    stream = getattr(link_data, split)
    ref = jax_build_csr(stream, num_nodes=link_data.num_nodes)
    ours = build_temporal_csr(stream, num_nodes=link_data.num_nodes)
    assert ours.nbr_hi.dtype == torch.int32
    np.testing.assert_array_equal(ours.nbr_hi.numpy(), np.asarray(ref.nbr_hi))


@pytest.mark.parametrize("hops", [2, 3])
def test_sample_multi_hop_bitwise_equal(small, hops):
    _, jax_csr, csr, _, ids, ts = small
    ref_blocks, ref_wins = jax_sample_multi_hop(
        jax_csr, jnp.asarray(ids), jnp.asarray(ts), K, hops, "recent", return_windows=True
    )
    blocks, wins = sample_multi_hop(
        csr, torch.from_numpy(ids), torch.from_numpy(ts), K, hops, return_windows=True
    )
    assert len(blocks) == len(wins) == hops
    for h, (blk, ref) in enumerate(zip(blocks, ref_blocks)):
        for f in ("nbr", "eid", "ts", "mask"):
            np.testing.assert_array_equal(getattr(blk, f).numpy(), np.asarray(getattr(ref, f)),
                                          err_msg=f"hop {h} {f}")
        np.testing.assert_array_equal(wins[h].numpy(), np.asarray(ref_wins[h]))
    assert blocks[-1].mask.any() and not blocks[0].mask[-1].any()  # id 0 has no history


def test_sample_recent_bitwise_equal(small):
    _, jax_csr, csr, _, ids, ts = small
    ref = jax_sample_recent(jax_csr, jnp.asarray(ids), jnp.asarray(ts), K)
    ours = sample_recent(csr, torch.from_numpy(ids), torch.from_numpy(ts), K)
    for f in ("nbr", "eid", "ts", "mask"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)))


def test_fetch_entry_windows_bitwise_equal(small):
    data, jax_csr, csr, _, ids, ts = small
    _, wins = sample_multi_hop(csr, torch.from_numpy(ids), torch.from_numpy(ts), K, 2,
                               return_windows=True)
    width = FEAT + FEAT
    for win in wins:
        ours = fetch_entry_windows(csr, win, K)
        ref = jax_fetch_entry_windows(jax_csr, jnp.asarray(win.numpy()), K)
        assert ours.shape == (*win.shape, K, width)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref)[..., :width])


@pytest.mark.parametrize("strategy", ["uniform", "time_interval_aware"])
def test_stochastic_strategies_sample_and_raise_only_without_a_generator(small, strategy):
    """``uniform`` and ``time_interval_aware`` sample (no entry windows: the
    gathered kernel takes layer 1), and raise only when no generator is
    given to draw from."""
    data, _, csr, _, ids, ts = small
    if strategy == "time_interval_aware":  # its draws search csr.tia_cew
        csr = build_temporal_csr(data.full, num_nodes=data.num_nodes, with_tia=True)
    tgat = TGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT, sample_strategy=strategy,
                wants_entry_features=True)
    assert not tgat._window_kernel and tgat._gathered_kernel  # no windows under uniform
    with pytest.raises(ValueError, match="Generator"):
        tgat.sample(csr, torch.from_numpy(ids), torch.from_numpy(ts))
    inputs = tgat.sample(csr, torch.from_numpy(ids), torch.from_numpy(ts),
                         gen=torch.Generator().manual_seed(0))
    assert [x.shape for x in inputs.hop_ids] == [(B,), (B, K), (B, K * K)]
    assert inputs.hop_win_start is None and inputs.hop_node_feat is None


@pytest.mark.parametrize("kw", [
    dict(use_phi_fusion=True),
    dict(use_phi_fusion=True, sample_strategy="uniform"),
    dict(use_phi_fusion=True, wants_entry_features=True),
    dict(use_gathered_attention=True),
    dict(use_gathered_attention=True, use_phi_fusion=True),
    dict(use_window_attention=True, use_gathered_attention=True),
    dict(use_window_attention=True, use_phi_fusion=True),
    dict(use_window_attention=True, use_gathered_attention=True, use_phi_fusion=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_explicit_layer1_flags_resolve_as_jax(kw):
    """An explicit True for one layer-1 kernel beats the port's own "auto"
    (which turns the gathered kernel on), and two explicit Trues follow
    JAX's precedence: window, then gathered, then Phi fusion."""
    ours = TGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT, **kw)
    jax_tgat = JaxTGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT, **kw)
    flags = ("_window_kernel", "_gathered_kernel", "_phi_fusion")
    assert [getattr(ours, f) for f in flags] == [getattr(jax_tgat, f) for f in flags]


@pytest.mark.parametrize("config", ["default", "window"])
def test_sample_matches_jax(small, config):
    """Hop tensors, fetched hop features and (window) clamped starts."""
    _, jax_csr, csr, plain_csr, ids, ts = small
    kw, with_table = CONFIGS[config]
    jax_tgat = JaxTGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT, **kw)
    ref = jax_tgat.sample(jax_csr, jnp.asarray(ids), jnp.asarray(ts), jax.random.PRNGKey(0))
    ours = TGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT, **kw).sample(
        csr if with_table else plain_csr, torch.from_numpy(ids), torch.from_numpy(ts)
    )
    for f in ("hop_ids", "hop_eids", "hop_ts", "hop_mask", "hop_win_start"):
        a, b = getattr(ours, f), getattr(ref, f)
        if config == "default" and f == "hop_win_start":
            assert a is None
            continue
        assert len(a) == len(b), f
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f)
    if config == "window":
        n_hops = L - 1  # the window kernel reads the last hop's rows itself
        assert len(ours.hop_node_feat) == len(ours.hop_edge_feat) == n_hops
        for f in ("hop_node_feat", "hop_edge_feat"):
            for x, y in zip(getattr(ours, f), getattr(ref, f)):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f)
        assert ours.feat_table is csr.feat_entry
    else:
        assert ours.hop_node_feat is None and ours.feat_table is None


@pytest.fixture(scope="module")
def jax_reference(small):
    """The JAX plain f32 TGATNet's parameters and embeddings of the queries."""
    data, _, _, plain_csr, ids, ts = small
    jax_csr = jax_build_csr(data.full, num_nodes=data.num_nodes)
    tables = JaxTables(node=jnp.asarray(data.node_raw_features),
                       edge=jnp.asarray(data.edge_raw_features))
    tgat = JaxTGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT, **JAX_PLAIN)
    # jitted: op by op, init and apply take ~13 s on the CPU
    params = jax.jit(tgat.init)(jax.random.PRNGKey(1), tables, jax_csr)
    inputs = jax.jit(tgat.sample)(jax_csr, jnp.asarray(ids), jnp.asarray(ts),
                                  jax.random.PRNGKey(0))
    emb = jax.jit(tgat.apply)(params, tables, inputs)
    return jax.tree_util.tree_map(np.asarray, params), np.asarray(emb)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_tgatnet_matches_jax_plain(small, jax_reference, config):
    data, _, csr, plain_csr, ids, ts = small
    params, ref = jax_reference
    kw, with_table = CONFIGS[config]
    tgat = TGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT, **kw)
    net = tgat.build(FEAT, FEAT, torch.Generator().manual_seed(0)).eval()
    net.load_state_dict(module_state_dict(params))
    tables = FeatureTables(node=torch.from_numpy(data.node_raw_features),
                           edge=torch.from_numpy(data.edge_raw_features))
    inputs = tgat.sample(csr if with_table else plain_csr, torch.from_numpy(ids),
                         torch.from_numpy(ts))
    called = set()
    plain_fns = {name: getattr(ops, f"{name}_plain") for name in (
        "temporal_attention", "gathered_attention", "window_attention", "phi_projection")}
    for name, fn in plain_fns.items():  # record which kernels' plain versions run
        def spy(*a, _fn=fn, _name=name, **k):
            called.add(_name)
            return _fn(*a, **k)
        setattr(ops, f"{name}_plain", spy)
    try:
        with torch.no_grad():
            emb = net(tables, inputs)
            net.use_kernels = False
            emb_plain = net(tables, inputs)
    finally:
        for name, fn in plain_fns.items():
            setattr(ops, f"{name}_plain", fn)
    assert called == CONFIG_KERNELS[config]
    assert emb.shape == (B, FEAT) and torch.isfinite(emb).all()
    np.testing.assert_allclose(emb.numpy(), ref, atol=1e-5)
    torch.testing.assert_close(emb_plain, emb, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def jax_trainer(link_data, tmp_path_factory):
    """The JAX trainer with plain f32 TGAT at K = 5, dropout 0 (evaluation
    ignores dropout), and its seed-0 parameters and optimizer state."""
    jtr = JaxTrainer(
        JaxTGAT(num_neighbors=K, num_layers=L, dropout=0.0, **JAX_PLAIN), link_data,
        JaxConfig(batch_size=200, learning_rate=LR),
        str(tmp_path_factory.mktemp("jax") / "unused.pkl"),
    )
    params, opt_state = jtr.init_params(0)
    return jtr, params, opt_state


@pytest.fixture(scope="module")
def jax_eval(jax_trainer, link_data):
    """The JAX trainer's evaluate on the fixture's val split: (params,
    losses, per-batch probabilities, metrics)."""
    jtr, params, _ = jax_trainer
    recorded = []
    batch_metrics = jtr._batch_metrics

    def record(probs, b):
        recorded.append(jtr._host_probs(probs))
        return batch_metrics(probs, b)

    jtr._batch_metrics = record
    try:
        losses, metrics, _ = jtr.evaluate(params, link_data.val, jtr.val_neg, 0, scanned=False)
    finally:
        jtr._batch_metrics = batch_metrics
    return jax.tree_util.tree_map(np.asarray, params), losses, recorded, metrics


@pytest.mark.parametrize("config", ["plain_path", "default", "window", "phi_fusion"])
def test_evaluate_matches_jax(synthetic_dataset, jax_eval, config):
    params, j_losses, j_probs, j_metrics = jax_eval
    kw, with_table = CONFIGS[config]
    data = get_link_prediction_data("synthetic", data_root=synthetic_dataset)
    tr = LinkPredictionTrainer(TGAT(num_neighbors=K, num_layers=L, **kw), data,
                               TrainConfig(batch_size=200), device="cpu")
    assert (tr.full_csr.feat_entry is not None) == with_table
    tr.load_params(from_jax_params(params))
    losses, metrics, probs = tr.evaluate(data.val, tr.val_neg)
    assert len(probs) == len(j_probs) == len(j_losses) > 1
    for (pos, neg), (jpos, jneg) in zip(probs, j_probs):
        np.testing.assert_allclose(pos, jpos, atol=1e-5)
        np.testing.assert_allclose(neg, jneg, atol=1e-5)
    np.testing.assert_allclose(losses, j_losses, atol=1e-5)
    ours, ref = tr.mean_metrics(metrics), JaxTrainer.mean_metrics(j_metrics)
    for k in ref:
        assert abs(ours[k] - ref[k]) <= 1e-5, (k, ours[k], ref[k])


def test_train_step_on_cpu_gives_every_parameter_a_gradient(small):
    """TGAT trains on the CPU through the kernels' autograd Functions (plain
    forward, explicit plain backward): one step of the default
    configuration with dropout gives every parameter a finite gradient."""
    data, *_ = small
    tr = LinkPredictionTrainer(TGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT), data,
                               TrainConfig(batch_size=50), device="cpu")
    tr.init_params(0)
    _, arrays, bucket = next(iter(tr.train_batches()))
    loss, (pos, neg) = tr.train_step(arrays, bucket)
    assert bucket is None and torch.isfinite(loss) and pos.shape == (50,)
    for mod in (tr.model, tr.head):
        for name, p in mod.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name


# ---- uniform sampling
def _draws(csr, ids, ts, seed, return_windows=False):
    return sample_multi_hop(csr, torch.from_numpy(ids), torch.from_numpy(ts), K, 2, "uniform",
                            return_windows=return_windows, gen=torch.Generator().manual_seed(seed))


def _assert_inside_windows(csr, qids, qts, blk):
    """Every valid draw is an entry of the query node's strictly-before
    window (its edge id among the window's, its time before the query's);
    rows are time-sorted and all valid or all padded, exactly where the
    window is not empty."""
    lo, hi = window_bounds(csr, qids, qts)
    valid = blk.mask.reshape(qids.shape[0], -1)
    assert torch.equal(valid.all(-1), valid.any(-1))
    assert torch.equal(valid.all(-1), hi > lo)
    eids = blk.eid.reshape(valid.shape)
    times = blk.ts.reshape(valid.shape)
    assert (times[:, 1:] >= times[:, :-1]).all()
    for q in torch.nonzero(hi > lo).reshape(-1).tolist():
        window = set(csr.eid[lo[q]:hi[q]].tolist())
        assert set(eids[q].tolist()) <= window
        assert (times[q] < qts[q]).all()
    assert not eids[~valid].any() and not blk.nbr.reshape(valid.shape)[~valid].any()


def test_uniform_sampling_matches_the_jax_sampler_in_structure(small):
    _, jax_csr, csr, _, ids, ts = small
    jlo, jhi = jax_window_bounds(jax_csr, jnp.asarray(ids), jnp.asarray(ts))
    lo, hi = window_bounds(csr, torch.from_numpy(ids), torch.from_numpy(ts))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    ref, ref_wins = jax_sample_multi_hop(jax_csr, jnp.asarray(ids), jnp.asarray(ts), K, 2,
                                         "uniform", jax.random.PRNGKey(0), return_windows=True)
    blocks, wins = _draws(csr, ids, ts, 0, return_windows=True)
    assert wins is None and ref_wins is None  # windows exist only under recent
    # hop 1: validity depends on the windows only, so it equals JAX's
    np.testing.assert_array_equal(blocks[0].mask.numpy(), np.asarray(ref[0].mask))
    _assert_inside_windows(csr, torch.from_numpy(ids), torch.from_numpy(ts), blocks[0])
    # hop 2 is drawn from hop 1's draws: their nodes at their times
    q_ids, q_ts = blocks[0].nbr.reshape(-1), blocks[0].ts.reshape(-1)
    _assert_inside_windows(csr, q_ids, q_ts, blocks[1])
    jlo, jhi = jax_window_bounds(jax_csr, jnp.asarray(q_ids.numpy()), jnp.asarray(q_ts.numpy()))
    assert blocks[1].mask.reshape(-1, K).all(-1).numpy().tolist() == (
        np.asarray(jhi) > np.asarray(jlo)).tolist()
    assert blocks[1].mask.any() and not blocks[0].mask[-1].any()  # id 0 has no history


def test_uniform_draws_are_seeded(small):
    _, _, csr, _, ids, ts = small
    a, b, c = _draws(csr, ids, ts, 1), _draws(csr, ids, ts, 1), _draws(csr, ids, ts, 2)
    for x, y in zip(a, b):
        for f in ("nbr", "eid", "ts", "mask"):
            assert torch.equal(getattr(x, f), getattr(y, f))
    assert not torch.equal(a[1].eid, c[1].eid)


def test_uniform_draws_pass_a_chi_square_test(small):
    """20,000 draws from each of three windows of different sizes: the
    counts per window entry are consistent with uniform (chi-square, p >
    1e-3 for each)."""
    from scipy.stats import chisquare

    data, _, csr, _, _, _ = small
    nodes = torch.arange(1, data.num_nodes, dtype=torch.int32)
    t_end = torch.full_like(nodes, int(data.full.ts[-1]) + 1)
    lo, hi = window_bounds(csr, nodes, t_end)
    sizes = (hi - lo).tolist()
    picks = [int(np.argmin([abs(s - want) for s in sizes])) for want in (3, 12, 40)]
    reps = 1000
    for q in picks:
        n = sizes[q]
        blk = sample_uniform(csr, nodes[q].repeat(reps), t_end[q].repeat(reps), 20,
                             torch.Generator().manual_seed(q))
        assert blk.mask.all()
        window = csr.eid[lo[q]:hi[q]].tolist()
        assert len(set(window)) == n
        pos = {e: i for i, e in enumerate(window)}
        counts = np.bincount([pos[e] for e in blk.eid.reshape(-1).tolist()], minlength=n)
        assert counts.sum() == 20 * reps
        assert chisquare(counts).pvalue > 1e-3, (n, counts)


def test_uniform_evaluate_sweeps_are_repeatable(small):
    data, *_ = small
    tr = LinkPredictionTrainer(
        TGAT(num_neighbors=K, num_layers=L, time_feat_dim=DT, sample_strategy="uniform"), data,
        TrainConfig(batch_size=100), device="cpu",
    )
    tr.init_params(0)
    stream = data.val.slice(0, 300)
    first, second = (tr.evaluate(stream, tr.val_neg)[2] for _ in range(2))
    salted = tr.evaluate(stream, tr.val_neg, eval_key_salt=1)[2]
    assert len(first) == 3
    for (p1, n1), (p2, n2) in zip(first, second):
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(n1, n2)
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(first, salted))
    # training draws from the trainer's own generator, seeded by init_params
    _, arrays, _ = next(iter(tr.train_batches()))
    losses = []
    for _ in range(2):
        tr.init_params(3)
        losses.append(float(tr.train_step(arrays)[0]))
    assert losses[0] == losses[1]


# ---- training against the JAX trainer
TRAIN_CONFIGS = ["plain_path", "default", "window", "phi_fusion"]


@pytest.fixture(scope="module")
def port_data(synthetic_dataset):
    return get_link_prediction_data("synthetic", data_root=synthetic_dataset)


@pytest.fixture(scope="module")
def jax_train(jax_trainer):
    jtr, params, opt_state = jax_trainer
    return jtr, jax.tree_util.tree_map(np.asarray, params), opt_state


def _train_batches(port_data, idx):
    """Train batches ``idx`` with negatives from a seeded stream (the same
    numpy arrays feed both trainers)."""
    rng = np.random.RandomState(5)
    out = []
    for i, b in enumerate(chronological_batches(port_data.train, TRAIN_B)):
        neg = rng.choice(np.unique(port_data.train.dst), size=len(b.src))
        if i in idx:
            out.append((b, neg))
    return out


def _port_trainer(port_data, params, config):
    tr = LinkPredictionTrainer(
        TGAT(num_neighbors=K, num_layers=L, dropout=0.0, **CONFIGS[config][0]), port_data,
        TrainConfig(batch_size=TRAIN_B, learning_rate=LR), device="cpu",
    )
    tr.init_params(0)
    tr.load_params(from_jax_params(params))
    return tr


@pytest.fixture(scope="module")
def jax_grads(jax_train, port_data):
    """The JAX trainer's loss and gradients on train batch 2 (plain f32
    path, dropout 0), op by op: jitted, XLA would fuse the time encoder's
    dt * w + b into one rounding where PyTorch rounds twice."""
    jtr, params, _ = jax_train
    (b, neg), = _train_batches(port_data, {2})
    jarrays = jtr._batch_arrays(b, b.src, neg)

    def loss_fn(p):
        return jtr._forward(p, jtr.train_csr, jtr.tables, jarrays, jax.random.PRNGKey(0), True,
                            None, False, None)[0]

    loss, grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, params))
    return float(loss), from_jax_params(jax.tree_util.tree_map(np.asarray, grads)), (b, neg)


@pytest.mark.parametrize("config", TRAIN_CONFIGS)
def test_train_step_gradients_match_jax_grad(jax_train, jax_grads, port_data, config):
    _, params, _ = jax_train
    jloss, want, (b, neg) = jax_grads
    tr = _port_trainer(port_data, params, config)
    assert (tr.train_csr.feat_entry is not None) == (config == "window")
    before = ops.launch_counts()
    loss, _ = tr.train_step(tr._batch_arrays(b, b.src, neg))
    assert ops.launch_counts() == before  # CPU: the plain versions
    assert abs(float(loss) - jloss) < 1e-5
    got = {"backbone": {k: p.grad for k, p in tr.model.named_parameters()},
           "head": {k: p.grad for k, p in tr.head.named_parameters()}}
    # the largest gradient entry but the time encoder's (dt-scaled) ones
    net_scale = max(float(v.abs().max()) for sd in want.values() for k, v in sd.items()
                    if not k.startswith("time_encoder."))
    for part in ("backbone", "head"):
        assert set(got[part]) == set(want[part])
        for k, g in got[part].items():
            assert g is not None and torch.isfinite(g).all(), k
            ref = want[part][k].numpy()
            scale = float(np.abs(ref).max())
            assert scale > 0, k
            err = float(np.abs(g.numpy() - ref).max())
            if config == "phi_fusion":
                assert err <= max(1e-3 * scale, 5e-4 * net_scale), (k, err, scale, net_scale)
            else:
                assert err <= 2e-5 * scale, (config, k, err, scale)


def test_three_step_trajectory_matches_jax(jax_train, port_data):
    jtr, params, opt_state = jax_train
    tr = _port_trainer(port_data, params, "default")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for step, (b, neg) in enumerate(_train_batches(port_data, {0, 1, 2})):
        jp, opt_state, _, jloss, _ = jtr.train_step(
            jp, opt_state, None, jtr.train_csr, jtr._batch_arrays(b, b.src, neg),
            jax.random.PRNGKey(step),
        )
        loss, _ = tr.train_step(tr._batch_arrays(b, b.src, neg))
        assert abs(float(loss) - float(jloss)) < (1e-5 if step == 0 else 1e-4), step
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    for part, got in tr.state_dicts().items():
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[part][k].numpy(), atol=6 * LR, err_msg=k)


def test_initial_parameters_follow_the_jax_distributions(jax_train, port_data):
    """The two packages draw seed 0 from different generators but from the
    same distributions: the time encoder and the layer norms are the same
    constants; every other tensor is U(-b, b) with b = fan_in**-0.5 (torch
    nn.Linear's default), checked on both draws' largest entry and, for
    100 entries or more, their std against b / sqrt(3) (within 15%: the
    sample std of 100 uniform draws has a relative spread of ~4.5%)."""
    _, params, _ = jax_train
    want = from_jax_params(params)
    tr = LinkPredictionTrainer(TGAT(num_neighbors=K, num_layers=L, dropout=0.0), port_data,
                               TrainConfig(batch_size=TRAIN_B), device="cpu")
    tr.init_params(0)
    for part, got in tr.state_dicts().items():
        assert set(got) == set(want[part]), part
        for name, v in got.items():
            w = want[part][name]
            assert v.shape == w.shape, name
            if name.startswith("time_encoder.") or ".layer_norm." in name:
                torch.testing.assert_close(v, w, rtol=1e-6, atol=0.0, msg=name)
                continue
            b = got[name.rsplit(".", 1)[0] + ".weight"].shape[1] ** -0.5
            for draw in (v, w):
                assert float(draw.abs().max()) <= b, name
                if draw.numel() >= 100:
                    assert abs(float(draw.std()) * 3**0.5 / b - 1.0) < 0.15, name


def test_fit_one_epoch_returns_the_jax_results_keys(port_data, tmp_path):
    tr = LinkPredictionTrainer(
        TGAT(num_neighbors=3, num_layers=1, time_feat_dim=8), port_data,
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
