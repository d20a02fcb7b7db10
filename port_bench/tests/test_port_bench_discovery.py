"""A configuration, a cell, a per-layer metric and a kernel function are
found by name: one added as files is picked up without editing a file."""
import json

from port_bench import catalog

from . import _tiny


def test_names_match_the_manifest():
    manifest = json.loads((catalog.ROOT.parent / "BENCHMARK.json").read_text())
    found = catalog.names()
    assert sorted(c["name"] for c in manifest["configs"]) == found["configs"]
    assert sorted(w["name"] for w in manifest["workloads"]) == found["workloads"]
    assert sorted(m["name"] for m in manifest["per_layer"]) == found["metrics"]
    for c in manifest["configs"]:
        assert (catalog.ROOT.parent / c["file"]).is_file()
    for w in manifest["workloads"]:
        assert catalog.cell(w["name"])["config"] == w["config"]


def test_every_metric_names_its_layer_unit_and_end_to_end_metric():
    manifest = json.loads((catalog.ROOT.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name, mod in catalog.metrics().items():
        entry = entries[name]
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (entry["layer"], entry["unit"], entry["moves"])
        for cell in entry["workloads"]:
            assert catalog.cell(cell)["phase"] == mod.PHASE


def test_throwaway_files_are_picked_up(tmp_path):
    root = _tiny.make_root(tmp_path)
    (root / "configs" / "extra_cfg.json").write_text(
        json.dumps({**_tiny.CONFIGS["tiny_tgat"], "num_neighbors": 2}))
    (root / "workloads" / "extra_cfg.eval.json").write_text(json.dumps(
        {"config": "extra_cfg", "phase": "eval", "why": "t", "limits": {"prob_gap": 1.0}}))
    (root / "metrics" / "answer.eval.py").write_text(
        'LAYER = "x"\nUNIT = "%"\nMOVES = "eval_edges_per_s"\nPHASE = "eval"\n'
        "def read(run):\n    return 42.0\n")
    (root / "work" / "new_kernel.py").write_text(
        'KIND = "kernel"\nANCHOR = "new_kernel"\ndef calls(cell):\n    return [(2, 4)]\n')
    found = catalog.names(root)
    assert "extra_cfg" in found["configs"]
    assert "extra_cfg.eval" in found["workloads"]
    assert "answer.eval" in found["metrics"]
    assert "new_kernel" in found["work"]
    cell = catalog.cell("extra_cfg.eval", root)
    assert cell["cfg"]["num_neighbors"] == 2 and cell["cfg"]["name"] == "extra_cfg"
    assert catalog.metrics(root)["answer.eval"].read(None) == 42.0
    assert catalog.work(root)["new_kernel"].calls(cell) == [(2, 4)]


def test_time_interval_aware_cell_is_found():
    cell = catalog.cell("tgat_tia.train")
    assert cell["phase"] == "train" and cell["chips"] == 1
    cfg = cell["cfg"]
    assert cfg["sample_neighbor_strategy"] == "time_interval_aware"
    assert cfg["time_scaling_factor"] == 1e-6
    same = catalog.config("tgat_wikipedia")
    differ = {k for k in set(cfg) | set(same) if cfg.get(k) != same.get(k)}
    assert differ == {"name", "sample_neighbor_strategy", "time_scaling_factor", "published_as",
                      "assumed"}


def test_dygformer_wikipedia_cell_is_found():
    """DyGLib's default 32/1 DyGFormer on tgat_wikipedia's stream: the
    CanParl configuration's widths at wikipedia's operating point."""
    cell = catalog.cell("dygformer_wikipedia.train")
    assert cell["phase"] == "train" and cell["chips"] == 1 and cell["sweep_batches"] == 64
    cfg = cell["cfg"]
    assert (cfg["max_input_sequence_length"], cfg["patch_size"]) == (32, 1)
    assert cfg["stream"] == catalog.config("tgat_wikipedia")["stream"]
    same = catalog.config("dygformer_canparl")
    differ = {k for k in set(cfg) | set(same) if cfg.get(k) != same.get(k)}
    assert differ == {"name", "max_input_sequence_length", "patch_size", "stream",
                      "stream_source", "published_as", "assumed"}
