"""A benchmark root of tiny cells for the CPU tests: the real metrics/ and
work/ beside throwaway configurations and cells."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from port_bench import catalog

BIPARTITE = {"kind": "bipartite", "num_src": 60, "num_dst": 30, "num_edges": 1500,
             "node_feat_scale": 1.0}
# a few steps of many equal times each, histories longer than the sequence
YEARLY = {"kind": "yearly", "num_nodes": 50, "num_edges": 1500, "num_steps": 6, "seats": 30}
COMMON = {"num_layers": 2, "num_heads": 2, "dropout": 0.1, "time_feat_dim": 12, "node_dim": 172,
          "compute_dtype": "float32", "sample_neighbor_strategy": "recent", "batch_size": 40,
          "learning_rate": 0.0001, "precision": "float32",
          "peak": {"flops_per_s": 67e12, "precision": "float32", "source": "test"},
          "source": "test", "assumed": [], "reduced": []}
CONFIGS = {
    "tiny_dygformer": {"model": "DyGFormer", "max_input_sequence_length": 16, "patch_size": 4,
                       "channel_embedding_dim": 8, "stream": YEARLY, **COMMON},
    "tiny_tgat": {"model": "TGAT", "num_neighbors": 4, "stream": BIPARTITE, **COMMON},
    # the random strategies: the reference follows the port's draws
    "tiny_tgat_uniform": {"model": "TGAT", "num_neighbors": 4, "stream": BIPARTITE,
                          **{**COMMON, "sample_neighbor_strategy": "uniform"}},
    "tiny_tgat_tia": {"model": "TGAT", "num_neighbors": 4, "stream": BIPARTITE,
                      **{**COMMON, "sample_neighbor_strategy": "time_interval_aware",
                         "time_scaling_factor": 1e-6}},
}
# a pair-aware model (no reference module in the benchmark yet: the tests
# that use it bring their own), kept out of CONFIGS
PAIR_AWARE = {
    "tiny_cawn": {"model": "CAWN", "num_neighbors": 4, "walk_length": 1, "num_walk_heads": 2,
                  "position_feat_dim": 6, "stream": BIPARTITE,
                  **{**COMMON, "sample_neighbor_strategy": "time_interval_aware",
                     "time_scaling_factor": 1e-6}},
}
LIMITS = {"train": {"loss_gap": 1e-5, "grad_gap": 1e-4, "grad_median_gap": 1e-5,
                    "change_gap": 1e-4},
          "eval": {"prob_gap": 1e-5, "loss_gap": 1e-5}}


def make_root(tmp: Path, configs: dict = CONFIGS) -> Path:
    root = tmp / "bench"
    for d in ("metrics", "work"):
        shutil.copytree(catalog.ROOT / d, root / d)
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    for name, cfg in configs.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        for phase in ("train", "eval"):
            cell = {"config": name, "phase": phase, "chips": 1, "sweep_batches": 3,
                    "why": "test", "limits": LIMITS[phase]}
            (root / "workloads" / f"{name}.{phase}.json").write_text(json.dumps(cell))
    return root
