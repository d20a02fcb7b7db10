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
    does).

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
from dyglib_tpu.models import FeatureTables as JaxTables
from dyglib_tpu.models import TGAT as JaxTGAT
from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer
from dyglib_tpu.train import TrainConfig as JaxConfig
from dyglib_tpu_torch import ops
from dyglib_tpu_torch.data import get_link_prediction_data, synthetic_link_prediction_data
from dyglib_tpu_torch.graph import (
    build_temporal_csr,
    fetch_entry_windows,
    sample_multi_hop,
    sample_recent,
)
from dyglib_tpu_torch.models import TGAT, FeatureTables
from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig
from dyglib_tpu_torch.transfer import from_jax_params, module_state_dict

FEAT, DT, K, L, B = 12, 10, 5, 2, 16
# the port's configurations: (TGAT kwargs, whether the CSR holds the entry table)
CONFIGS = {
    "plain_path": (dict(use_fused_attention=False, use_gathered_attention=False), False),
    "default": ({}, False),
    "default_entry_table": ({}, True),
    "window": (dict(wants_entry_features=True), True),
    "phi_fusion": (dict(use_gathered_attention=False, use_phi_fusion=True), False),
}
# the kernels each configuration's net calls (their plain versions on the CPU)
CONFIG_KERNELS = {
    "plain_path": set(),
    "default": {"gathered_attention", "temporal_attention"},
    "default_entry_table": {"gathered_attention", "temporal_attention"},
    "window": {"window_attention", "temporal_attention"},
    "phi_fusion": {"phi_projection"},
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


def test_sample_strategies_other_than_recent_raise():
    with pytest.raises(ValueError, match="not ported"):
        TGAT(sample_strategy="uniform")


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
def jax_eval(link_data, tmp_path_factory):
    """The JAX trainer's evaluate on the fixture's val split, plain f32
    TGAT at K = 5: (params, losses, per-batch probabilities, metrics)."""
    jtr = JaxTrainer(
        JaxTGAT(num_neighbors=K, num_layers=L, **JAX_PLAIN), link_data,
        JaxConfig(batch_size=200), str(tmp_path_factory.mktemp("jax") / "unused.pkl"),
    )
    params, _ = jtr.init_params(0)
    recorded = []
    batch_metrics = jtr._batch_metrics

    def record(probs, b):
        recorded.append(jtr._host_probs(probs))
        return batch_metrics(probs, b)

    jtr._batch_metrics = record
    losses, metrics, _ = jtr.evaluate(params, link_data.val, jtr.val_neg, 0, scanned=False)
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
    """TGAT trains on the CPU through the plain versions (the card waits
    for the backward kernels): one step of the default configuration with
    dropout gives every parameter a finite gradient."""
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
