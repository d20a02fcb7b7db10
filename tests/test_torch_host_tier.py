"""The port's host tier against the JAX package, on the CPU.

  * ``parallel.host_batch_slice``: the JAX test's cases
    (``tests/test_distributed_helpers.py``), port against JAX, and a
    single-process ``initialize_distributed`` is a no-op;
  * ``utils.rng``: ``batch_key`` is deterministic and distinct per
    (epoch, batch); ``set_random_seed`` seeds the global generators;
  * ``data.statistics``: ``dataset_statistics`` and the CLI table equal
    the JAX package's on the test fixture;
  * ``data.preprocess`` without pandas: ``parse_float`` reads decimal
    fields bit for bit as pandas' parser does (which is not always
    ``float()``); ``preprocess_dataset`` on raw CSVs written here
    (bipartite, not bipartite, no feature columns; 17-digit and 6-digit
    fields, a timestamp tie) gives files byte-identical to the JAX
    package's (which uses pandas); the
    ``--all`` CLI processes what is present and skips the rest;
    ``check_processed`` passes on equal directories and raises on a
    changed one, as the JAX one does;
  * ``native``: the C++ CSR builder's arrays equal the port's numpy path
    and the JAX package's ``build_temporal_csr`` (random streams, nodes
    without edges, ties, a node on both sides of an edge), and
    ``graph.build_temporal_csr`` gives the same CSR through either path.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from dyglib_tpu.data import preprocess as jax_pre
from dyglib_tpu.data import statistics as jax_stats
from dyglib_tpu.parallel.distributed import host_batch_slice as jax_host_batch_slice
from dyglib_tpu_torch.data import get_link_prediction_data
from dyglib_tpu_torch.data import preprocess as pre
from dyglib_tpu_torch.data import statistics as stats
from dyglib_tpu_torch.graph import csr as port_csr
from dyglib_tpu_torch.native import build_temporal_csr_native, native_available
from dyglib_tpu_torch.parallel import host_batch_slice, initialize_distributed
from dyglib_tpu_torch.utils import rng


@pytest.mark.parametrize("b,p", [(200, 1), (200, 4), (200, 7), (8, 8), (5, 8)])
def test_host_batch_slices_match_jax(b, p):
    covered = np.zeros(b, dtype=int)
    for i in range(p):
        off, ln = host_batch_slice(b, i, p)
        assert (off, ln) == jax_host_batch_slice(b, i, p)
        covered[off: off + ln] += 1
    assert (covered == 1).all()


def test_initialize_single_process_is_a_noop():
    import torch.distributed as dist

    assert initialize_distributed() == (0, 1)
    assert initialize_distributed(None, 1, 0, device="cpu") == (0, 1)
    assert not dist.is_initialized()


def test_batch_key_is_deterministic_and_distinct():
    keys = {(e, b): rng.batch_key(7, e, b) for e in range(20) for b in range(50)}
    assert len(set(keys.values())) == len(keys)
    assert all(rng.batch_key(7, e, b) == k for (e, b), k in keys.items())
    assert rng.batch_key(8, 0, 0) != keys[(0, 0)]
    assert all(0 <= k < 2**63 for k in keys.values())


def test_set_random_seed_and_generators():
    import random

    g = rng.set_random_seed(3)
    a = (random.random(), np.random.rand(), torch.rand(()).item(), torch.rand((), generator=g))
    g = rng.set_random_seed(3)
    assert a == (random.random(), np.random.rand(), torch.rand(()).item(),
                 torch.rand((), generator=g))
    # the trainers' seeds: the run's seed, and 12345 + salt for an eval sweep
    assert torch.equal(torch.rand(4, generator=rng.generator(5)),
                       torch.rand(4, generator=torch.Generator().manual_seed(5)))
    assert rng.eval_seed(2) == 12347


def test_dataset_statistics_match_jax(link_data, synthetic_dataset):
    d = get_link_prediction_data("synthetic", data_root=synthetic_dataset)
    for ours, theirs in ((d.full, link_data.full), (d.train, link_data.train)):
        assert stats.dataset_statistics(ours, d.node_raw_features, d.edge_raw_features) == \
            jax_stats.dataset_statistics(theirs, link_data.node_raw_features,
                                         link_data.edge_raw_features)


def test_statistics_cli_matches_jax(synthetic_dataset, capsys):
    jax_stats.main(["--data_root", synthetic_dataset])
    theirs = capsys.readouterr().out
    stats.main(["--data_root", synthetic_dataset])
    assert capsys.readouterr().out == theirs


def _write_raw(path, rows, header="user_id,item_id,timestamp,state_label,comma_separated_list_of_features"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(header + "\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")


def _raw_rows(seed, n=300, n_src=20, n_dst=12, feats=4, bipartite=True):
    rs = np.random.RandomState(seed)
    ts = np.sort(rs.randint(0, 10_000, n) + 0.5 * rs.randint(0, 2, n))
    ts[5] = ts[4]  # a tie
    src = rs.randint(0, n_src, n)
    dst = rs.randint(0, n_dst, n) if bipartite else rs.randint(0, n_src, n)
    src[:n_src], dst[:n_dst] = np.arange(n_src), np.arange(n_dst)  # contiguous ids
    rows = []
    for k in range(n):
        f = [round(v, 6) for v in rs.randn(feats)]
        if f:
            f[0] = float(rs.randn())  # full float64 digits in one column
        rows.append([src[k], dst[k], ts[k], rs.randint(0, 2), *f])
    return rows


RAW_CASES = {
    "bipartite": dict(bipartite=True, feats=4),
    "not_bipartite": dict(bipartite=False, feats=3),
    "no_features": dict(bipartite=True, feats=0),
}


@pytest.mark.parametrize("case", sorted(RAW_CASES))
def test_preprocess_is_byte_identical_to_jax(tmp_path, case):
    kw = RAW_CASES[case]
    raw = str(tmp_path / "raw" / "toy.csv")
    _write_raw(raw, _raw_rows(1, **kw))
    jax_pre.preprocess_dataset(raw, str(tmp_path / "jax"), "toy", bipartite=kw["bipartite"],
                               node_feat_dim=16)
    pre.preprocess_dataset(raw, str(tmp_path / "port"), "toy", bipartite=kw["bipartite"],
                           node_feat_dim=16)
    for name in ("ml_toy.csv", "ml_toy.npy", "ml_toy_node.npy"):
        assert (tmp_path / "port" / "toy" / name).read_bytes() == \
            (tmp_path / "jax" / "toy" / name).read_bytes(), name
    # the loaders read it back
    d = get_link_prediction_data("toy", data_root=str(tmp_path / "port"))
    assert d.full.num_interactions == 300


@pytest.mark.parametrize("scale", [1.0, 1e-5, 1e6, 1e-300])
def test_parse_float_reads_as_pandas(scale):
    import io

    import pandas as pd

    rs = np.random.RandomState(0)
    texts = [repr(float(v)) for v in rs.randn(3000) * scale] + ["36.0", "-0.0", "1.5E+10", "7"]
    ref = pd.read_csv(io.StringIO("x\n" + "\n".join(texts))).x.to_numpy(np.float64)
    got = np.array([pre.parse_float(t) for t in texts])
    np.testing.assert_array_equal(got.view(np.int64), ref.view(np.int64))


def test_preprocess_refuses_what_jax_refuses(tmp_path):
    rows = _raw_rows(2)
    rows[10][2], rows[11][2] = 9e9, 1.0  # time goes backwards
    _write_raw(str(tmp_path / "desc.csv"), rows)
    with pytest.raises(AssertionError):
        jax_pre.parse_raw_csv(str(tmp_path / "desc.csv"))
    with pytest.raises(ValueError, match="ascending"):
        pre.parse_raw_csv(str(tmp_path / "desc.csv"))
    gap = _raw_rows(3)
    for r in gap:
        r[0] = r[0] * 2  # source ids 0, 2, 4, ...: not contiguous
    _write_raw(str(tmp_path / "gap.csv"), gap)
    with pytest.raises(AssertionError):
        jax_pre.reindex(jax_pre.parse_raw_csv(str(tmp_path / "gap.csv"))[0], bipartite=True)
    with pytest.raises(ValueError, match="contiguous"):
        pre.reindex(pre.parse_raw_csv(str(tmp_path / "gap.csv"))[0], bipartite=True)


def test_preprocess_cli_all_skips_missing(tmp_path, capsys):
    _write_raw(str(tmp_path / "DG_data" / "uci" / "uci.csv"), _raw_rows(4, bipartite=False))
    pre.main(["--all", "--data_root", str(tmp_path / "DG_data"), "--out_root",
              str(tmp_path / "out"), "--node_feat_dim", "8"])
    out = capsys.readouterr().out
    assert "processed uci" in out and "skip wikipedia" in out
    jax_pre.main(["--dataset_name", "uci", "--data_root", str(tmp_path / "DG_data"),
                  "--out_root", str(tmp_path / "jax_out"), "--node_feat_dim", "8"])
    for name in ("ml_uci.csv", "ml_uci.npy", "ml_uci_node.npy"):
        assert (tmp_path / "out" / "uci" / name).read_bytes() == \
            (tmp_path / "jax_out" / "uci" / name).read_bytes()
    with pytest.raises(SystemExit):
        pre.main(["--data_root", str(tmp_path / "DG_data")])  # neither --all nor a name


@pytest.mark.parametrize("change", ["none", "ts", "u", "node_feats"])
def test_check_processed_agrees_with_jax(tmp_path, change):
    raw = str(tmp_path / "raw.csv")
    _write_raw(raw, _raw_rows(5))
    for side in ("ref", "out"):
        pre.preprocess_dataset(raw, str(tmp_path / side), "toy", node_feat_dim=8)
    out = tmp_path / "out" / "toy"
    if change in ("ts", "u"):
        lines = (out / "ml_toy.csv").read_text().splitlines()
        cells = lines[3].split(",")
        cells[{"u": 1, "ts": 3}[change]] = str(float(cells[3]) + 7.0) if change == "ts" else "99"
        lines[3] = ",".join(cells)
        (out / "ml_toy.csv").write_text("\n".join(lines) + "\n")
    elif change == "node_feats":
        np.save(out / "ml_toy_node.npy", np.ones((4, 8)))
    args = (str(tmp_path / "ref"), str(tmp_path / "out"), "toy")
    if change == "none":
        pre.check_processed(*args)
        jax_pre.check_processed(*args)
    else:
        with pytest.raises(AssertionError):
            pre.check_processed(*args)
        with pytest.raises(AssertionError):
            jax_pre.check_processed(*args)


def _stream(src, dst, ts):
    from dyglib_tpu_torch.data import EdgeStream

    n = len(src)
    return EdgeStream(src=np.asarray(src, np.int64), dst=np.asarray(dst, np.int64),
                      ts=np.asarray(ts, np.float64), eid=np.arange(1, n + 1, dtype=np.int64),
                      label=np.zeros(n))


def _random_stream(seed, e=5000, n=300):
    rs = np.random.default_rng(seed)
    return _stream(rs.integers(1, n // 2, e), rs.integers(n // 2, n, e),
                   np.sort(rs.uniform(0, 1e6, e))), n


CSR_CASES = {
    "random": lambda: _random_stream(0),
    # ids 1..9 never appear: empty segments
    "empty_nodes": lambda: (_stream([10, 12, 10], [30, 31, 30], [1.0, 2.0, 3.0]), 40),
    "ties": lambda: (_stream([1, 2, 1, 3, 2], [2, 1, 2, 1, 3], [5.0, 5.0, 5.0, 7.0, 7.0]), 4),
    "self_loop": lambda: (_stream([1, 2, 2], [1, 2, 3], [1.0, 1.0, 2.0]), 4),
}

needs_native = pytest.mark.skipif(not native_available(), reason="no host C++ compiler")


@needs_native
@pytest.mark.parametrize("case", sorted(CSR_CASES))
def test_native_builder_matches_numpy_and_jax(case):
    from dyglib_tpu.graph import build_temporal_csr as jax_build

    stream, n = CSR_CASES[case]()
    native = build_temporal_csr_native(stream.src, stream.dst, stream.eid, stream.ts, n)
    plain = port_csr._entries_numpy(stream, n)
    for a, b in zip(native, plain):
        np.testing.assert_array_equal(a, b.astype(a.dtype))
    j = jax_build(stream, num_nodes=n)
    p = port_csr.build_temporal_csr(stream, n)
    for field in ("offsets", "nbr", "eid", "ts", "nbr_hi"):
        np.testing.assert_array_equal(getattr(p, field).numpy(), np.asarray(getattr(j, field)),
                                      err_msg=field)


@needs_native
@pytest.mark.parametrize("extras", [{}, {"with_tia": True, "time_scaling_factor": 1e-6},
                                    {"feat_prefix_of": "node"}], ids=["plain", "tia", "prefix"])
def test_csr_is_the_same_through_either_path(monkeypatch, link_data, synthetic_dataset, extras):
    d = get_link_prediction_data("synthetic", data_root=synthetic_dataset)
    kw = dict(extras)
    if "feat_prefix_of" in kw:
        kw["feat_prefix_of"] = d.node_raw_features
    native = port_csr.build_temporal_csr(d.full, d.num_nodes, **kw)
    monkeypatch.setattr(port_csr, "build_temporal_csr_native", lambda *a: None)
    plain = port_csr.build_temporal_csr(d.full, d.num_nodes, **kw)
    for f in dataclasses.fields(native):
        a, b = getattr(native, f.name), getattr(plain, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name
