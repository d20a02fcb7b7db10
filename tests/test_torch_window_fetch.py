"""The port's entry-ordered feature table and window fetch against the JAX
package on the CPU.

  * ``feat_entry``: the port keeps the packed row-major table without the
    JAX package's 128-lane padding; it must equal the JAX table's first
    dn + de columns, row for row;
  * the fetch (its plain version, which the CPU wrapper takes) must equal
    ``fetch_sequence_features(..., interpret=True)`` bitwise, on random
    windows and on a DyGFormer batch;
  * the port's entry-fetch path must give the same node/edge tensors as
    its gather path (bitwise) and so the same embeddings; those embeddings
    are held to the JAX gather path at 1e-5 (the JAX entry-fetch model
    rounds its packed projection to bf16, so it is no yardstick).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.graph import build_temporal_csr as jax_build_csr
from dyglib_tpu.graph.csr import feat_entry_guard_pad as jax_guard_pad
from dyglib_tpu.graph.csr import time_keys
from dyglib_tpu.models import DyGFormer as JaxDyGFormer
from dyglib_tpu.models import FeatureTables as JaxTables
from dyglib_tpu.ops.pallas.window_fetch import fetch_sequence_features as jax_fetch
from dyglib_tpu_torch import ops
from dyglib_tpu_torch.data import get_link_prediction_data
from dyglib_tpu_torch.graph import build_temporal_csr
from dyglib_tpu_torch.models import DyGFormer
from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig
from dyglib_tpu_torch.transfer import from_jax_params

MAXLEN, PATCH = 64, 4


@pytest.fixture(scope="module")
def env(link_data, synthetic_dataset):
    d = link_data
    feats = (d.node_raw_features, d.edge_raw_features)
    kw = dict(num_nodes=d.num_nodes, feat_entry_of=feats, feat_entry_pad=MAXLEN)
    jax_packed = jax_build_csr(d.full, feat_entry_layout="packed", **kw)
    jax_slabs = jax_build_csr(d.full, feat_entry_layout="slabs", **kw)
    data = get_link_prediction_data("synthetic", data_root=synthetic_dataset)
    port = build_temporal_csr(
        data.full, num_nodes=data.num_nodes,
        feat_entry_of=(data.node_raw_features, data.edge_raw_features), feat_entry_pad=MAXLEN,
    )
    return d, data, jax_packed, jax_slabs, port


def test_feat_entry_equals_jax_table(env):
    d, _, jax_packed, _, port = env
    width = d.node_raw_features.shape[1] + d.edge_raw_features.shape[1]
    ref = np.asarray(jax_packed.feat_entry)
    assert port.feat_entry.shape == (ref.shape[0], width) and ref.shape[1] > width
    np.testing.assert_array_equal(port.feat_entry.numpy(), ref[:, :width])
    assert not ref[:, width:].any()  # the JAX lane padding holds nothing
    assert port.feat_entry_guard_pad == jax_guard_pad(jax_packed) >= MAXLEN
    assert port.feat_entry_node_dim == d.node_raw_features.shape[1]


def test_feat_entry_refuses_nonzero_row_zero(env):
    _, data, _, _, _ = env
    node = data.node_raw_features.copy()
    node[0, 3] = 1.0
    with pytest.raises(ValueError, match="row 0"):
        build_temporal_csr(
            data.full, num_nodes=data.num_nodes, feat_entry_of=(node, data.edge_raw_features)
        )


def test_plain_fetch_equals_jax_kernel_on_random_windows(env):
    _, _, _, jax_slabs, port = env
    pad = port.feat_entry_guard_pad
    rs = np.random.RandomState(3)
    n = 23
    starts = (rs.randint(0, port.num_entries - 40, n) + pad).astype(np.int32)
    counts = rs.randint(0, MAXLEN - 1, n).astype(np.int32)
    counts[:3] = (0, MAXLEN - 1, 1)  # empty, full and one-entry windows
    tgts = (2 * pad + port.num_entries + rs.randint(0, port.num_nodes, n)).astype(np.int32)
    ref = np.asarray(jax_fetch(
        jax_slabs.feat_entry_slabs, jnp.asarray(tgts), jnp.asarray(starts), jnp.asarray(counts),
        MAXLEN, tile=16, interpret=True,
    ))
    before = ops.fetch_sequence_features.launches
    node, edge = ops.fetch_sequence_features(
        port.feat_entry, *(torch.from_numpy(a) for a in (tgts, starts, counts)), MAXLEN,
        port.feat_entry_node_dim,
    )
    assert ops.fetch_sequence_features.launches == before  # CPU: plain version
    got = torch.cat([node, edge], dim=-1).numpy()
    np.testing.assert_array_equal(got, ref[..., : got.shape[-1]])


def _batch(d, b=32):
    v = d.val
    ids = np.r_[v.src[:b], v.dst[:b], v.dst[b : 2 * b]].astype(np.int32)
    ts = np.tile(time_keys(v.ts[:b]), 3).astype(np.int32)
    return ids, ts


def test_sample_fetch_equals_jax_and_gather_path(env):
    d, data, _, _, _ = env
    ids, ts = _batch(d)
    kw = dict(max_input_sequence_length=MAXLEN, patch_size=PATCH, num_layers=1)
    # JAX: the entry-fetch sample (slab kernel, interpret mode) and the
    # gather-path forward
    jfetch = JaxDyGFormer(**kw, use_entry_fetch=True, use_time_kernel=False,
                          gelu_approximate=False)
    jplain = JaxDyGFormer(**kw, use_time_kernel=False, gelu_approximate=False)
    feats = (d.node_raw_features, d.edge_raw_features)
    jcsr = jax_build_csr(d.full, num_nodes=d.num_nodes, feat_entry_of=feats,
                         feat_entry_pad=jfetch.entry_window_rows, feat_entry_layout="slabs")
    key = jax.random.PRNGKey(0)
    jin = jfetch.sample(jcsr, jnp.asarray(ids), jnp.asarray(ts), key)
    jt = JaxTables(node=jnp.asarray(feats[0]), edge=jnp.asarray(feats[1]))
    params = jplain.init(jax.random.PRNGKey(0), jt, jcsr)
    jref = np.asarray(jplain.apply(params, jt, jplain.sample(jcsr, jnp.asarray(ids),
                                                             jnp.asarray(ts), key), triple=True))

    # port: a trainer builds feat_entry for an entry-fetch backbone
    tr = LinkPredictionTrainer(DyGFormer(**kw, use_entry_fetch=True), data,
                               TrainConfig(batch_size=32), device="cpu")
    assert tr.full_csr.feat_entry is not None and tr.train_csr.feat_entry is not None
    tr.init_params(0)
    jparams = {"backbone": jax.tree_util.tree_map(np.asarray, params), "head": {}}
    tr.model.load_state_dict(from_jax_params(jparams)["backbone"])
    inputs = tr.backbone.sample(tr.full_csr, torch.from_numpy(ids), torch.from_numpy(ts))
    node, edge = inputs.entry_window.fetch(inputs.seq_ids.shape[1])
    width = node.shape[-1] + edge.shape[-1]
    got = torch.cat([node, edge], dim=-1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jin.seq_feat)[..., :width])
    # bitwise equal to the gather path's tensors
    np.testing.assert_array_equal(node, tr.tables.node[inputs.seq_ids.long()])
    np.testing.assert_array_equal(edge, tr.tables.edge[inputs.seq_eids.long()])
    with torch.no_grad():
        emb_fetch = tr.model(tr.tables, inputs, triple=True)
        emb_gather = tr.model(tr.tables, inputs._replace(entry_window=None), triple=True)
    np.testing.assert_array_equal(emb_fetch.numpy(), emb_gather.numpy())
    np.testing.assert_allclose(emb_fetch.numpy(), jref, atol=1e-5)


def test_no_table_past_the_budget_or_without_the_flag(env, monkeypatch):
    from dyglib_tpu_torch.train import link_prediction

    _, data, _, _, _ = env
    tr = LinkPredictionTrainer(DyGFormer(), data, TrainConfig(), device="cpu")
    assert tr.full_csr.feat_entry is None
    monkeypatch.setattr(link_prediction, "ENTRY_TABLE_BUDGET", 1000)
    tr = LinkPredictionTrainer(DyGFormer(use_entry_fetch=True), data, TrainConfig(), device="cpu")
    assert tr.full_csr.feat_entry is None  # the gather path then serves
