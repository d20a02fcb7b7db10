"""What the benchmark finds by name under its root.

  * ``configs/<config>.json``: a configuration (model, widths, stream);
  * ``workloads/<cell>.json``: a cell: its configuration, phase, sweep
    and the limits its check holds;
  * ``metrics/<metric>.py``: a per-layer metric's reader, with its
    ``LAYER``, ``UNIT``, ``MOVES`` and ``read(run)``;
  * ``work/<function>.py``: the work of one of the program's kernel
    functions (``KIND = "kernel"``) or of a model's step (``KIND =
    "model"``).

A new cell, configuration, metric or kernel function is a new file; no
file here lists them.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str, root: Path = ROOT) -> dict:
    path = root / "configs" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no configuration {name!r} under {root / 'configs'}")
    cfg = _json(path)
    cfg["name"] = name
    return cfg


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration under ``"cfg"``."""
    path = root / "workloads" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no workload {name!r} under {root / 'workloads'}")
    c = _json(path)
    c["name"] = name
    c["cfg"] = config(c["config"], root)
    return c


def _modules(folder: Path, prefix: str) -> dict:
    mods = {}
    for path in sorted(folder.glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(f"{prefix}{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods[path.stem] = mod
    return mods


def metrics(root: Path = ROOT) -> dict:
    """{metric name: reader module}."""
    return _modules(root / "metrics", "port_bench_metric_")


def work(root: Path = ROOT) -> dict:
    """{function name: work module}."""
    return _modules(root / "work", "port_bench_work_")


def names(root: Path = ROOT) -> dict:
    """Every configuration, cell, metric and work function found."""
    stems = lambda d, ext: sorted(p.name[: -len(ext)] for p in (root / d).glob(f"*{ext}")
                                  if not p.name.startswith("_"))
    return {"configs": stems("configs", ".json"), "workloads": stems("workloads", ".json"),
            "metrics": stems("metrics", ".py"), "work": stems("work", ".py")}
