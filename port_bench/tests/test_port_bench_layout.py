"""Any stateless backbone of the port through the benchmark: ``Program``
builds TGAT, CAWN, TCL, GraphMixer and DyGFormer with their configured
widths (a field left out at the port's command-line default), and reports
the rows its trainer embeds a batch in; the reference embeds the rows its
net module's ``LAYOUT`` names, triple or quad; a run whose two layouts
differ is not correct; and the pick check reads CAWN's hop tables in the
quad."""
import io
import json
import sys
import types

import numpy as np
import pytest
import torch

from port_bench import catalog, harness, traffic, weights
from port_bench.program import Program
from port_bench.reference import TGAT as ref_tgat
from port_bench.reference.graph import time_keys
from port_bench.reference.train import Reference

from . import _tiny

# every field the factory reads, each away from the port's command-line
# default (configs/args.py), and the backbone attribute that carries it
FIELDS = {"num_neighbors": ("num_neighbors", 3), "num_layers": ("num_layers", 1),
          "num_heads": ("num_heads", 4), "dropout": ("dropout", 0.2),
          "time_feat_dim": ("time_feat_dim", 12),
          "sample_neighbor_strategy": ("sample_strategy", "uniform"),
          "compute_dtype": ("compute_dtype", "bfloat16"), "walk_length": ("walk_length", 2),
          "num_walk_heads": ("num_walk_heads", 2), "position_feat_dim": ("position_feat_dim", 6),
          "time_gap": ("time_gap", 7), "max_input_sequence_length": ("max_input_sequence_length", 8),
          "patch_size": ("patch_size", 2), "channel_embedding_dim": ("channel_embedding_dim", 8)}
# the fields the factory reads for each model
READS = {"TGAT": ("num_neighbors", "num_layers", "num_heads", "dropout", "time_feat_dim",
                  "sample_neighbor_strategy", "compute_dtype"),
         "CAWN": ("num_neighbors", "walk_length", "num_walk_heads", "dropout", "time_feat_dim",
                  "position_feat_dim", "sample_neighbor_strategy", "compute_dtype"),
         "TCL": ("num_neighbors", "num_layers", "num_heads", "dropout", "time_feat_dim",
                 "sample_neighbor_strategy"),
         "GraphMixer": ("num_neighbors", "num_layers", "dropout", "time_feat_dim", "time_gap",
                        "sample_neighbor_strategy"),
         "DyGFormer": ("max_input_sequence_length", "patch_size", "channel_embedding_dim",
                       "num_layers", "num_heads", "dropout", "time_feat_dim", "compute_dtype")}
TRAIN = {"batch_size": 40, "learning_rate": 1e-4}


@pytest.fixture(scope="module")
def splits():
    return traffic.make_splits(_tiny.BIPARTITE, 2**35 + 1)


@pytest.mark.parametrize("model", sorted(READS))
def test_program_builds_every_field(splits, model):
    cfg = {"model": model, **TRAIN, **{k: FIELDS[k][1] for k in READS[model]}}
    backbone = Program(cfg, splits, "cpu").tr.backbone
    for k in READS[model]:
        attr, value = FIELDS[k]
        assert getattr(backbone, attr) == value, k


@pytest.mark.parametrize("model", sorted(READS))
def test_weights_make_every_parameter(splits, model):
    """The benchmark's starting parameters cover each model's, in its
    initialisation's distribution: CAWN's LSTM directions U(+-1/sqrt(H)),
    GraphMixer's LayerNorms 1 and 0."""
    prog = Program({"model": model, **TRAIN}, splits, "cpu")
    params = prog.start(1, lambda shapes: weights.make(shapes, 2, "cpu"), 3, 4, 5)
    assert params and all(torch.isfinite(v).all() for v in params.values())
    for name, v in params.items():
        if name.endswith(("_wx", "_wh", "_b", "_bh")):
            bound = (v.shape[-1] // 4) ** -0.5
            assert 0.9 * bound < float(v.abs().max()) <= bound, name
        if name.endswith("_norm.weight"):
            assert bool((v == 1).all()), name


def test_left_out_fields_take_the_command_line_defaults(splits):
    backbone = Program({"model": "CAWN", **TRAIN}, splits, "cpu").tr.backbone
    got = {k: getattr(backbone, k) for k in ("num_neighbors", "walk_length", "num_walk_heads",
                                             "position_feat_dim", "time_feat_dim", "dropout")}
    assert got == {"num_neighbors": 20, "walk_length": 1, "num_walk_heads": 8,
                   "position_feat_dim": 172, "time_feat_dim": 100, "dropout": 0.1}
    assert backbone.sample_strategy == "recent"


@pytest.mark.parametrize("name,want", [("tiny_cawn", "quad"), ("tiny_tgat", "dedup"),
                                       ("tiny_tgat_tia", "dedup"),
                                       ("tiny_dygformer", "triple")])
def test_program_reports_the_trainers_layout(name, want):
    cfg = {**_tiny.CONFIGS, **_tiny.PAIR_AWARE}[name]
    prog = Program(cfg, traffic.make_splits(cfg["stream"], 3), "cpu")
    assert prog.layouts == {"train": want, "eval": want}


def quad_module(seen: dict) -> types.ModuleType:
    """A reference net module of the quad layout: CAWN's walk trees drawn as
    TGAT's hops (one a step of the walk), a logit linear in one parameter;
    what it is given is kept in ``seen``."""
    net = types.ModuleType("port_bench.reference.CAWN")
    net.LAYOUT = "quad"

    def prepare(cfg, hist, ids, t, device, gen=None):
        seen.setdefault("ids", []).append(np.array(ids))
        seen.setdefault("t", []).append(np.array(t))
        return ref_tgat.prepare({**cfg, "num_layers": cfg["walk_length"]}, hist, ids, t, device,
                                gen)

    def dropout_draws(cfg, rows, gen, device):
        seen.setdefault("rows", []).append(rows)
        return [torch.rand((rows, 2), generator=gen, device=device) < 1.0 - cfg["dropout"]]

    def pair_logits(params, cfg, tables, inp, prec, b, drops=None):
        x = inp["ids"][0].to(torch.float32) * params["w"]
        return x[:b] - x[b : 2 * b], x[2 * b : 3 * b] - x[3 * b :]

    net.prepare, net.dropout_draws, net.pair_logits = prepare, dropout_draws, pair_logits
    return net


@pytest.fixture
def cawn_root(tmp_path):
    return _tiny.make_root(tmp_path, _tiny.PAIR_AWARE)


def test_reference_embeds_the_quad(monkeypatch, cawn_root):
    seen = {}
    monkeypatch.setitem(sys.modules, "port_bench.reference.CAWN", quad_module(seen))
    cfg = catalog.config("tiny_cawn", cawn_root)
    sp = traffic.make_splits(cfg["stream"], 5)
    ref = Reference(cfg, sp, "cpu")
    b = 7
    t = sp.train
    neg = t.dst[b : 2 * b][::-1].copy()
    batch = (t.src[:b], t.dst[:b], neg, t.ts[:b], np.ones(b, np.float32))
    losses, first, _ = ref.follow({"w": torch.tensor(0.01)}, [batch, batch], 1, 2)
    assert len(losses) == 2 and float(first["w"]) != 0.0
    assert seen["rows"] == [4 * b, 4 * b]
    np.testing.assert_array_equal(seen["ids"][0], np.concatenate([t.src[:b], t.dst[:b],
                                                                  t.src[:b], neg]))
    np.testing.assert_array_equal(seen["t"][0], np.tile(time_keys(t.ts[:b]), 4))


def test_triple_reference_is_unchanged():
    """The triple's rows and dropout rows, as before the layouts."""
    cfg = _tiny.CONFIGS["tiny_dygformer"]
    ref = Reference(cfg, traffic.make_splits(cfg["stream"], 5), "cpu")
    src, dst, neg, ts = np.arange(3), np.arange(3) + 3, np.arange(3) + 6, np.arange(3.0)
    ids, t = ref.queries(src, dst, neg, ts)
    np.testing.assert_array_equal(ids, np.concatenate([src, dst, neg]))
    np.testing.assert_array_equal(t, np.tile(time_keys(ts), 3))
    assert ref.layout == "triple" and ref.rows(3) == 9


@pytest.mark.parametrize("phase", ["train", "eval"])
def test_layouts_that_differ_are_not_correct(monkeypatch, tmp_path, phase):
    """A reference module whose layout is not the program's: its numbers
    may agree, the run is still not correct, and standard error names
    both layouts."""
    root = _tiny.make_root(tmp_path)
    monkeypatch.setattr(ref_tgat, "LAYOUT", "triple")
    out, err = io.StringIO(), io.StringIO()
    rc = harness.execute(catalog.cell(f"tiny_tgat.{phase}", root), 3, 0.0, False,
                         harness.Clock(), device="cpu", root=root, out=out, err=err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False
    assert all(v["value"] <= v["limit"] for v in line["checks"].values())
    assert "'dedup'" in err.getvalue() and "'triple'" in err.getvalue()


@pytest.mark.parametrize("phase", ["train", "eval"])
def test_pick_check_reads_cawns_hops_in_the_quad(monkeypatch, cawn_root, phase):
    """The port's CAWN at K 4, walk length 1, time-interval-aware: the
    reference's draws over the quad's queries pick what the port's sampler
    picked, and drawing from the next seed does not."""
    seen = {}
    monkeypatch.setitem(sys.modules, "port_bench.reference.CAWN", quad_module(seen))
    run = harness.Run(catalog.cell(f"tiny_cawn.{phase}", cawn_root), 2**40 + 3, 0.0, "cpu")
    run.setup(err=io.StringIO())
    assert run.layouts == ("quad", "quad") and run.layout_note() is None
    assert run.pick_differences() == 0
    b = run.batch
    for ids in seen["ids"]:
        np.testing.assert_array_equal(ids[:b], ids[2 * b : 3 * b])
    assert len(seen["ids"][0]) == 4 * b
    assert run.pick_differences(other=1) > 0
