"""The benchmark's stream and split are the port's generator's and
split's, array for array, for seeds beyond 32 bits too."""
import numpy as np
import pytest

from dyglib_tpu_torch.data.containers import EdgeStream
from dyglib_tpu_torch.data.datasets import split_link_prediction_data
from dyglib_tpu_torch.data.synthetic import make_synthetic_bipartite
from port_bench import traffic


def loop_items(u, fresh, repeat):
    """The generator's per-edge loop, as the port writes it."""
    out = np.empty(len(u), dtype=np.int64)
    last = {}
    for k in range(len(u)):
        if repeat[k] and int(u[k]) in last:
            out[k] = last[int(u[k])]
        else:
            out[k] = fresh[k]
            last[int(u[k])] = int(out[k])
    return out


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
def test_repeat_items_is_the_loop(seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 50, 3000)
    fresh = rng.integers(0, 40, 3000)
    repeat = rng.uniform(size=3000) < 0.8
    assert np.array_equal(traffic.repeat_items(u, fresh, repeat), loop_items(u, fresh, repeat))


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_stream_and_split_are_the_ports(seed):
    kw = dict(num_src=80, num_dst=30, num_edges=4000, node_feat_scale=1.0)
    stream, ef, nf = traffic.synthetic_bipartite(**kw, seed=seed)
    p_stream, p_ef, p_nf = make_synthetic_bipartite(**kw, seed=seed)
    for a in ("src", "dst", "ts", "eid", "label"):
        assert np.array_equal(getattr(stream, a), getattr(p_stream, a))
    assert np.array_equal(ef, p_ef) and np.array_equal(nf, p_nf)
    ours = traffic.split(stream, ef, nf)
    theirs = split_link_prediction_data(p_stream, p_ef, p_nf)
    assert np.array_equal(ours.node_feats, theirs.node_raw_features)
    assert np.array_equal(ours.edge_feats, theirs.edge_raw_features)
    for part in ("full", "train", "val", "test", "new_node_val", "new_node_test"):
        for a in ("src", "dst", "ts", "eid"):
            assert np.array_equal(getattr(getattr(ours, part), a),
                                  getattr(getattr(theirs, part), a)), (part, a)


@pytest.mark.parametrize("seed", [4, 2**35 + 7])
def test_yearly_stream_has_its_counts(seed):
    kw = dict(num_nodes=120, num_edges=6000, num_steps=7, seats=60)
    stream, ef, nf = traffic.synthetic_yearly(**kw, seed=seed)
    assert len(stream) == 6000 and set(np.unique(stream.ts)) == set(range(7))
    assert np.all(np.diff(stream.ts) >= 0) and np.all(stream.src != stream.dst)
    nodes = np.union1d(stream.src, stream.dst)
    assert nodes.min() == 1 and nodes.max() == 120 and len(nodes) == 120  # every node sits
    assert len(np.intersect1d(stream.src, stream.dst)) > 100  # not bipartite
    for step in range(7):
        at = stream.ts == step
        pairs = np.sort(np.stack([stream.src[at], stream.dst[at]], 1), 1)
        assert len(np.unique(pairs, axis=0)) == at.sum()  # distinct pairs a step
        assert len(np.union1d(stream.src[at], stream.dst[at])) <= 60  # the seated alone
    assert ef.shape == (6001, 1) and ef[0, 0] == 0 and ef[1:].min() >= 1
    assert nf.shape == (121, traffic.FEAT_DIM) and not nf.any()
    again = traffic.synthetic_yearly(**kw, seed=seed)[0]
    assert np.array_equal(stream.src, again.src) and np.array_equal(stream.dst, again.dst)


@pytest.mark.parametrize("seed", [5, 2**34 + 3])
def test_yearly_split_is_the_ports(seed):
    stream, ef, nf = traffic.synthetic_yearly(num_nodes=120, num_edges=6000, num_steps=7,
                                              seats=60, seed=seed)
    ours = traffic.split(stream, ef, nf)
    p_stream = EdgeStream(src=stream.src, dst=stream.dst, ts=stream.ts, eid=stream.eid,
                          label=stream.label)
    theirs = split_link_prediction_data(p_stream, ef, nf)
    assert ours.edge_feats.shape == (6001, traffic.FEAT_DIM)
    assert np.array_equal(ours.edge_feats, theirs.edge_raw_features)
    for part in ("train", "val", "test", "new_node_val", "new_node_test"):
        for a in ("src", "dst", "ts", "eid"):
            assert np.array_equal(getattr(getattr(ours, part), a),
                                  getattr(getattr(theirs, part), a)), (part, a)
    assert len(ours.val) > 0 and len(ours.train) > 0


def test_sub_seeds_differ_and_fit():
    seeds = {traffic.sub_seed(2**45 + 9, k) for k in ("init", "weights", "dropout", "negatives")}
    assert len(seeds) == 4 and all(0 <= s < 2**32 for s in seeds)
    assert traffic.sub_seed(5, "stream", 63) == traffic.sub_seed(5, "stream", 63)


def test_sweeps_cycle_through_whole_batches():
    rows = traffic.train_sweep_rows(1050, 200, 4, 3)
    assert list(rows[:3]) == [800, 801, 802]
    assert list(rows[200:203]) == [0, 1, 2]  # 5 whole batches: batch 5 is batch 0
    assert len(rows) == 600 and rows.max() < 1000
