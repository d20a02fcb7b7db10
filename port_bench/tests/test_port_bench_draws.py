"""The reference draws the neighbours the port draws: under ``uniform`` and
``time_interval_aware``, from the same seed, the reference's picks are the
port's plain path's, entry for entry, over a train cell's followed steps and
over an eval sweep, and at the edges (empty windows, weights that all
underflow, a second hop over padded entries); and the control that draws
from another seed comes out not correct."""
import io
import json

import numpy as np
import pytest
import torch

from dyglib_tpu_torch.data.containers import EdgeStream
from dyglib_tpu_torch.graph.csr import build_temporal_csr
from dyglib_tpu_torch.graph.sampler import sample_multi_hop
from dyglib_tpu_torch.models.tgat import TGAT
from port_bench import catalog, harness, traffic
from port_bench.reference.graph import History, time_keys

from . import _tiny

RANDOM = {"uniform": "tiny_tgat_uniform", "time_interval_aware": "tiny_tgat_tia"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("tiny"))


def _hops(inp) -> list:
    """A sample's hops as host arrays: (ids, edge ids, times, mask) each."""
    host = lambda ts: [t.cpu().numpy().reshape(-1) for t in ts]
    return list(zip(host(inp.hop_ids[1:]), host(inp.hop_eids), host(inp.hop_ts[1:]),
                    host(inp.hop_mask)))


@pytest.mark.parametrize("phase", ["train", "eval"])
@pytest.mark.parametrize("strategy", sorted(RANDOM))
def test_reference_picks_what_the_timed_path_picked(root, monkeypatch, strategy, phase):
    """The port's sampler as the set-up's steps (train: the three followed
    steps and the sweep after them) or its sweep (eval) called it, against
    the reference's picks for the same batches and seed."""
    seen = []
    real = TGAT.sample

    def sample(self, csr, ids, ts, gen=None):
        inp = real(self, csr, ids, ts, gen=gen)
        seen.append((ids.cpu().numpy(), ts.cpu().numpy(), _hops(inp)))
        return inp

    monkeypatch.setattr(TGAT, "sample", sample)
    run = harness.Run(catalog.cell(f"{RANDOM[strategy]}.{phase}", root), 2**40 + 9, 0.0, "cpu")
    run.follow_sweep = True
    run.setup(err=io.StringIO())
    if phase == "train":
        batches, hist, seed = run._train_batches(), "train_hist", run.seeds["sample"]
    else:
        batches, hist, seed = run._eval_batches()[0], "full_hist", run.eval_seed
    assert len(seen) == len(batches)
    ref = run._reference_model()
    gen = ref.generator(seed)
    picked = 0
    for (ids, ts, hops), b in zip(seen, batches):
        want_ids, want_t = np.concatenate(b[:3]), np.tile(time_keys(b[3]), 3)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(ts, want_t)
        inp = ref.net.prepare(run.cfg, getattr(ref, hist), want_ids, want_t, "cpu", gen)
        for h, got in enumerate(hops):
            mine = (inp["ids"][h + 1], inp["eids"][h], inp["t"][h + 1], inp["mask"][h])
            for a, g in zip(mine, got):
                np.testing.assert_array_equal(a.numpy(), g)
            picked += int(got[3].sum())
    assert picked > 0
    assert run.pick_differences() == 0


def _stream(seed=5, span=2000.0):
    s, _, _ = traffic.synthetic_bipartite(20, 10, 300, edge_feat_dim=2, time_span=span, seed=seed)
    return s


@pytest.mark.parametrize("alpha", [1e-6, 1e-2, 1.0])
@pytest.mark.parametrize("strategy", sorted(RANDOM))
def test_picks_at_the_edges(strategy, alpha):
    """Two hops over queries with empty windows (times before a node's
    first interaction, nodes with none), where the second hop starts from
    padded entries; at alpha 1 most early weights underflow to 0, so many
    windows take the uniform fallback."""
    s = _stream()
    n = int(max(s.src.max(), s.dst.max())) + 2  # one node without history
    csr = build_temporal_csr(EdgeStream(src=s.src, dst=s.dst, ts=s.ts, eid=s.eid,
                                        label=s.label), num_nodes=n, with_tia=True,
                             time_scaling_factor=alpha)
    hist = History(s.src, s.dst, s.ts, s.eid, n)
    rng = np.random.default_rng(3)
    q = 64
    ids = rng.integers(1, n, q)
    ids[:4] = n - 1
    t = time_keys(rng.uniform(0, 2100, q))
    t[4:8] = 0
    k = 5
    port_gen = torch.Generator().manual_seed(77)
    blocks = sample_multi_hop(csr, torch.from_numpy(ids).to(torch.int32),
                              torch.from_numpy(t).to(torch.int32), k, 2, strategy,
                              gen=port_gen)
    ref_gen = torch.Generator().manual_seed(77)
    nodes, times = ids, t
    for h, blk in enumerate(blocks):
        shape = (q,) if h == 0 else (q, k**h)
        got = hist.sample(strategy, nodes, times, k, ref_gen, shape, alpha)
        for a, b in zip(got, (blk.nbr, blk.eid, blk.ts, blk.mask)):
            np.testing.assert_array_equal(a.reshape(-1), b.numpy().reshape(-1))
        nodes, times = got[0].reshape(-1), got[2].reshape(-1)
    lo, hi = hist.before(ids, t)
    assert (hi == lo).sum() >= 8  # empty windows
    assert (~blocks[0].mask.numpy()).any() and blocks[1].mask.numpy().any()
    if strategy == "time_interval_aware":
        cew, _ = hist.tia_weights(alpha)
        lo1, hi1 = hist.before(blocks[0].nbr.numpy().reshape(-1), blocks[0].ts.numpy().reshape(-1))
        fallback = (hi1 > lo1) & (cew[np.maximum(hi1 - 1, 0)] <= 0)
        assert fallback.any() == (alpha == 1.0)


def test_weights_follow_dyglib_softmax():
    """The float32 cumulative weights give DyGLib's probabilities: the
    softmax over the window of CAWN's logits."""
    s = _stream(span=400.0)
    hist = History(s.src, s.dst, s.ts, s.eid, int(s.dst.max()) + 1)
    alpha = 1e-2
    cew, key = hist.tia_weights(alpha)
    assert np.all(np.diff(key) >= 0)
    node = int(np.bincount(hist.node).argmax())
    a, b = hist.start[node], hist.start[node + 1]
    times = hist.ts[a:b]
    ew = np.exp(alpha * (times - times.max()))
    logits = ew / np.cumsum(ew)
    for hi in (1, (b - a) // 2, b - a):
        p = np.exp(logits[:hi]) / np.exp(logits[:hi]).sum()
        w = np.diff(np.concatenate([[0.0], cew[a : a + hi].astype(np.float64)]))
        np.testing.assert_allclose(w / w.sum(), p, rtol=1e-5)


@pytest.mark.parametrize("phase", ["train", "eval"])
@pytest.mark.parametrize("strategy", sorted(RANDOM))
def test_other_draws_control_fails(root, strategy, phase):
    """The reference in the program's place, drawing from the next seed:
    ``correct`` comes out false through the run's own judgement."""
    out = io.StringIO()
    rc = harness.execute(catalog.cell(f"{RANDOM[strategy]}.{phase}", root), 7, 0.0, False,
                         harness.Clock(), device="cpu", root=root, out=out, err=io.StringIO(),
                         control="other_draws")
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False, line["checks"]
