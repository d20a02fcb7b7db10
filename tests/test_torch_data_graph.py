"""Port data layer, temporal CSR, sampling and negatives against the JAX
package on the CPU. Everything here is integer or copied data, so every
comparison is exact (bitwise)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.graph import build_temporal_csr as jax_build_csr
from dyglib_tpu.graph import window_bounds as jax_window_bounds
from dyglib_tpu.graph.csr import time_keys as jax_time_keys
from dyglib_tpu.graph.neg_sampler import NegativeEdgeSampler as JaxNegSampler
from dyglib_tpu.models import DyGFormer as JaxDyGFormer
from dyglib_tpu_torch.data import (
    chronological_batches,
    get_link_prediction_data,
    synthetic_link_prediction_data,
)
from dyglib_tpu_torch.graph import NegativeEdgeSampler, build_temporal_csr, window_bounds
from dyglib_tpu_torch.graph.csr import time_keys
from dyglib_tpu_torch.models import DyGFormer

SPLITS = ("full", "train", "val", "test", "new_node_val", "new_node_test")
FIELDS = ("src", "dst", "ts", "eid", "label")


def _assert_same_data(ours, ref):
    np.testing.assert_array_equal(ours.node_raw_features, ref.node_raw_features)
    np.testing.assert_array_equal(ours.edge_raw_features, ref.edge_raw_features)
    assert ours.node_raw_features.dtype == ref.node_raw_features.dtype == np.float32
    for split in SPLITS:
        a, b = getattr(ours, split), getattr(ref, split)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{split}.{f}")


def test_processed_loader_matches_jax(synthetic_dataset, link_data):
    """Reading ml_<name>.csv without pandas gives the same splits."""
    ours = get_link_prediction_data("synthetic", data_root=synthetic_dataset)
    _assert_same_data(ours, link_data)


def test_in_memory_synthetic_matches_jax_files(link_data):
    """Same seed, same draws: the in-memory stream equals the one the JAX
    package wrote to disk and read back (the conftest fixture's settings)."""
    ours = synthetic_link_prediction_data(
        num_src=120, num_dst=60, num_edges=2000, node_feat_scale=1.0, seed=7
    )
    _assert_same_data(ours, link_data)


@pytest.fixture(scope="module")
def csrs(link_data):
    d = link_data
    return {
        split: (
            jax_build_csr(getattr(d, split), num_nodes=d.num_nodes),
            build_temporal_csr(getattr(d, split), num_nodes=d.num_nodes),
        )
        for split in ("train", "full")
    }


@pytest.mark.parametrize("split", ["train", "full"])
def test_csr_bitwise_equal(csrs, split):
    ref, ours = csrs[split]
    for f in ("offsets", "nbr", "eid", "ts"):
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype == np.int32, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ours.segment_bisect_steps == ref.segment_bisect_steps


def test_time_keys_match():
    ts = np.array([0.0, 1.0, 2.5, 1e6, 3.0000001])
    np.testing.assert_array_equal(time_keys(ts), jax_time_keys(ts))


def _queries(d, n, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, d.num_nodes, size=n).astype(np.int32)
    ts = time_keys(rng.uniform(d.full.ts.min() - 10, d.full.ts.max() + 10, size=n))
    return ids, ts.astype(np.int32)


def test_window_bounds_equal(csrs, link_data):
    ref, ours = csrs["full"]
    ids, ts = _queries(link_data, 300, 0)
    lo_j, hi_j = jax_window_bounds(ref, jnp.asarray(ids), jnp.asarray(ts))
    lo, hi = window_bounds(ours, torch.from_numpy(ids), torch.from_numpy(ts))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_j))


@pytest.mark.parametrize(
    "maxlen,patch,bucket", [(32, 1, None), (32, 1, 8), (32, 4, None), (32, 4, 16)]
)
def test_dygformer_sample_equal(csrs, link_data, maxlen, patch, bucket):
    ref, ours = csrs["full"]
    ids, ts = _queries(link_data, 96, 1)
    jm = JaxDyGFormer(max_input_sequence_length=maxlen, patch_size=patch)
    tm = DyGFormer(max_input_sequence_length=maxlen, patch_size=patch)
    assert tm.seq_len == jm.seq_len
    assert tm.bucket_candidates == jm.bucket_candidates
    j_in = jm.sample(ref, jnp.asarray(ids), jnp.asarray(ts), jax.random.PRNGKey(0), seq_len=bucket)
    t_in = tm.sample(ours, torch.from_numpy(ids), torch.from_numpy(ts), seq_len=bucket)
    for f in ("seq_ids", "seq_eids", "seq_ts", "query_ts"):
        a, b = getattr(t_in, f).numpy(), np.asarray(getattr(j_in, f))
        assert a.dtype == b.dtype == np.int32, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_val_negative_draws_equal(link_data):
    d = link_data
    ref = JaxNegSampler(d.full.src, d.full.dst, seed=0)
    ours = NegativeEdgeSampler(d.full.src, d.full.dst, seed=0)
    for sweep in range(2):  # reset_random_state replays the stream
        ref.reset_random_state()
        ours.reset_random_state()
        for size in (200, 200, 37):
            for a, b in zip(ours.sample(size), ref.sample(size)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("maxlen,patch", [(32, 1), (256, 4)])
def test_pick_bucket_equal(link_data, maxlen, patch):
    """The port pads every batch to the bucket the JAX package picks (the
    early batches of the full stream have short histories, so they pick
    buckets below the full length)."""
    from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer
    from dyglib_tpu.train import TrainConfig as JaxConfig
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    d = link_data
    kw = dict(max_input_sequence_length=maxlen, patch_size=patch)
    jtr = JaxTrainer(JaxDyGFormer(**kw), d, JaxConfig(batch_size=64), "unused.pkl")
    ttr = LinkPredictionTrainer(DyGFormer(**kw), d, TrainConfig(batch_size=64), device="cpu")
    assert ttr._buckets == jtr._buckets and ttr._buckets is not None
    jtr.val_neg.reset_random_state()
    ttr.val_neg.reset_random_state()
    picked = []
    batches = list(chronological_batches(d.full, 64))[:10]
    batches += list(chronological_batches(d.val, 64))
    for b in batches:
        _, nd_j = jtr.val_neg.sample(b.num_valid)
        _, nd_t = ttr.val_neg.sample(b.num_valid)
        ns = ttr._pad_negs(b.src[: b.num_valid], b)
        nd = ttr._pad_negs(nd_t, b)
        np.testing.assert_array_equal(nd, jtr._pad_negs(nd_j, b))
        bt = ttr._pick_bucket(ttr.full_csr, b, ns, nd)
        assert bt == jtr._pick_bucket(jtr.full_csr, b, ns, nd)
        picked.append(bt)
    assert None in picked and any(p is not None for p in picked)
