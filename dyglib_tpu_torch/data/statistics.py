"""Dataset statistics table (reference preprocess_data/data_statistics.py:1-25).

Counterpart of ``dyglib_tpu/data/statistics.py``, in numpy only:
``python -m dyglib_tpu_torch.data.statistics [--data_root D] [names...]``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from .containers import EdgeStream

COLUMNS = [
    "dataset", "num_nodes", "num_edges", "num_unique_edges", "time_span", "mean_degree",
    "label_positive_rate", "node_feat_dim", "edge_feat_dim",
]


def dataset_statistics(
    stream: EdgeStream,
    node_feats: np.ndarray | None = None,
    edge_feats: np.ndarray | None = None,
) -> dict:
    """Numbers of nodes, edges and distinct (src, dst) pairs, the time span,
    the mean degree, the positive-label rate and the feature widths."""
    uniq = np.unique(np.concatenate([stream.src, stream.dst]))
    e = stream.num_interactions
    stats = {
        "num_nodes": int(len(uniq)),
        "num_edges": int(e),
        "num_unique_edges": int(len(np.unique(stream.src.astype(np.int64) << 32 | stream.dst))),
        "time_span": float(stream.ts.max() - stream.ts.min()) if e else 0.0,
        "mean_degree": float(2 * e / max(len(uniq), 1)),
        "label_positive_rate": float(np.mean(stream.label)) if e else 0.0,
    }
    if node_feats is not None:
        stats["node_feat_dim"] = int(node_feats.shape[1])
    if edge_feats is not None:
        stats["edge_feat_dim"] = int(edge_feats.shape[1])
    return stats


def statistics_table(names: list[str], data_root: str) -> list[str]:
    """The table's lines: a header, then one right-aligned row a dataset."""
    from .datasets import _load_processed

    rows = []
    for name in names:
        stream, edge_feats, node_feats = _load_processed(name, data_root)
        s = dataset_statistics(stream, node_feats, edge_feats)
        rows.append([name] + [round(v, 4) if isinstance(v := s.get(c, ""), float) else v
                              for c in COLUMNS[1:]])
    widths = [max(len(str(x)) for x in [c] + [r[i] for r in rows])
              for i, c in enumerate(COLUMNS)]
    fmt = lambda r: "  ".join(str(x).rjust(w) for x, w in zip(r, widths))
    return [fmt(COLUMNS)] + [fmt(r) for r in rows]


def main(argv: list[str] | None = None) -> None:
    """Print the table over the processed datasets named (default: every
    directory under ``--data_root``)."""
    parser = argparse.ArgumentParser("Dataset statistics")
    parser.add_argument("names", nargs="*", help="dataset names (default: all present)")
    parser.add_argument("--data_root", type=str, default="./processed_data")
    args = parser.parse_args(argv)
    names = args.names or sorted(
        d for d in os.listdir(args.data_root) if os.path.isdir(os.path.join(args.data_root, d)))
    for line in statistics_table(names, args.data_root):
        print(line)


if __name__ == "__main__":
    main()
