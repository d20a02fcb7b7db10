"""The CSR's GraphMixer and CAWN tables and the time_interval_aware sampler
of the port against the JAX package on the CPU.

  * ``csr.tia_cew`` and ``csr.feat_prefix`` are host numpy in both
    packages: equal bit for bit;
  * ``tia_select``, handed the JAX sampler's uniforms and fallback offsets
    (drawn from its key), returns the JAX ``_tia_indices``' indices and
    validity, index for index, including windows whose weights are all
    zero (the uniform fallback) and empty windows;
  * the port's own draws (from a ``torch.Generator``, whose bits differ
    from JAX's keys) follow the softmax of the reference's logits: total
    variation within 1.5x numpy's own sampling noise at the same count,
    as the JAX package's test holds its sampler; multi-hop draws stay in
    their windows and are time-sorted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.graph import build_temporal_csr as jax_build_csr
from dyglib_tpu.graph.sampler import _tia_indices as jax_tia_indices
from dyglib_tpu.graph.sampler import window_bounds as jax_window_bounds
from dyglib_tpu_torch.data import get_link_prediction_data
from dyglib_tpu_torch.graph import (
    build_temporal_csr,
    sample_multi_hop,
    sample_neighbors,
    tia_select,
    window_bounds,
)

ALPHA, K = 1e-5, 6


@pytest.fixture(scope="module")
def csrs(link_data, synthetic_dataset):
    data = get_link_prediction_data("synthetic", data_root=synthetic_dataset)
    kw = dict(num_nodes=data.num_nodes, time_scaling_factor=ALPHA, with_tia=True)
    ours = build_temporal_csr(data.train, feat_prefix_of=data.node_raw_features, **kw)
    ref = jax_build_csr(link_data.train, feat_prefix_of=link_data.node_raw_features, **kw)
    return data, ours, ref


def _queries(data, n=96, seed=0):
    rng = np.random.RandomState(seed)
    s = data.train
    idx = rng.randint(0, s.num_interactions, n)
    ids = np.where(rng.rand(n) < 0.5, s.src[idx], s.dst[idx]).astype(np.int32)
    ts = (np.ceil(s.ts[idx]) + rng.choice([0, 1, 500], size=n)).astype(np.int32)
    ids[:4] = 0  # pad queries: empty windows
    return ids, ts


def test_tables_equal_jax(csrs):
    _, ours, ref = csrs
    np.testing.assert_array_equal(ours.tia_cew.numpy(), np.asarray(ref.tia_cew))
    np.testing.assert_array_equal(ours.feat_prefix.numpy(), np.asarray(ref.feat_prefix))
    assert ours.tia_cew.dtype == ours.feat_prefix.dtype == torch.float32


@pytest.mark.parametrize("zero_weights", [False, True])
def test_search_matches_jax_index_for_index(csrs, zero_weights):
    data, ours, ref = csrs
    ids, ts = _queries(data)
    if zero_weights:  # every window's total <= 0: the uniform fallback
        ours = dataclasses.replace(ours, tia_cew=torch.zeros_like(ours.tia_cew))
        ref = ref._replace(tia_cew=jnp.zeros_like(ref.tia_cew))
    lo, hi = jax_window_bounds(ref, jnp.asarray(ids), jnp.asarray(ts))
    key = jax.random.PRNGKey(7)
    want_idx, want_valid = jax_tia_indices(ref, lo, hi, K, key)
    key_u, key_f = jax.random.split(key)
    u = np.array(jax.random.uniform(key_u, lo.shape + (K,)))
    r = np.array(jax.random.randint(key_f, lo.shape + (K,), 0,
                                      jnp.maximum(hi - lo, 1)[..., None]))
    t_lo, t_hi = window_bounds(ours, torch.from_numpy(ids), torch.from_numpy(ts))
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(hi))
    idx, valid = tia_select(ours, t_lo, t_hi, torch.from_numpy(u), torch.from_numpy(r))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert valid.numpy().any() and not valid.numpy()[:4].any()


def test_draws_follow_the_reference_softmax(csrs):
    """Empirical frequencies against softmax(v), v_i = exp(a dt_i) /
    sum_{j<=i} exp(a dt_j) over the node's visible window."""
    _, csr, _ = csrs
    offsets = csr.offsets.numpy().astype(np.int64)
    deg = np.diff(offsets)
    node = int(np.argmax(deg))
    lo = offsets[node]
    seg_ts = csr.ts.numpy()[lo : lo + deg[node]].astype(np.float64)
    ew = np.exp(ALPHA * (seg_ts - seg_ts.max()))
    v = ew / np.cumsum(ew)
    p = np.exp(v - v.max())
    p /= p.sum()
    reps, k = 4000, 32
    t_max = int(seg_ts.max()) + 1
    blk = sample_neighbors(csr, torch.full((reps,), node), torch.full((reps,), t_max), k,
                           "time_interval_aware", torch.Generator().manual_seed(4))
    assert blk.mask.all()
    eids = csr.eid.numpy()[lo : lo + deg[node]]
    pos = {e: i for i, e in enumerate(eids)}
    counts = np.bincount([pos[e] for e in blk.eid.numpy().ravel()], minlength=len(p))
    tv = 0.5 * np.abs(counts / counts.sum() - p).sum()
    rng = np.random.RandomState(0)
    emp_np = np.bincount(rng.choice(len(p), size=reps * k, p=p), minlength=len(p)) / (reps * k)
    tv_floor = 0.5 * np.abs(emp_np - p).sum()
    assert tv < 1.5 * tv_floor + 1e-3, (tv, tv_floor)


def test_multi_hop_draws_stay_in_their_windows(csrs):
    data, csr, _ = csrs
    ids, ts = _queries(data, 32, seed=1)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="Generator"):
        sample_multi_hop(csr, torch.from_numpy(ids), torch.from_numpy(ts), 3, 2,
                         "time_interval_aware")
    blocks = sample_multi_hop(csr, torch.from_numpy(ids), torch.from_numpy(ts), 3, 2,
                              "time_interval_aware", gen=gen)
    assert [b.nbr.shape for b in blocks] == [(32, 3), (32, 3, 3)]
    q_ts = torch.from_numpy(ts)[:, None]
    for blk, anchor in ((blocks[0], q_ts), (blocks[1], blocks[0].ts[..., None])):
        m = blk.mask
        assert (blk.ts[m] < anchor.expand_as(blk.ts)[m]).all()  # strictly before
        assert (blk.nbr[~m] == 0).all()
        assert (blk.ts.diff(dim=-1)[m[..., 1:]] >= 0).all()  # time-sorted
    no_tia = build_temporal_csr(data.train, num_nodes=data.num_nodes)
    with pytest.raises(ValueError, match="with_tia"):
        sample_neighbors(no_tia, torch.from_numpy(ids), torch.from_numpy(ts), 3,
                         "time_interval_aware", gen)
