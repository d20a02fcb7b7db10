"""The processed-dataset layout that every loader reads.

Counterpart of ``dyglib_tpu/data/preprocess.py``'s ``DATASET_NAMES`` and
``write_processed``, written without pandas. Under
``<out_dir>/<name>/``:

  ml_<name>.csv       the edge list: pandas' unnamed index column, then
                      u, i, ts, label, idx (what the JAX writer's
                      ``DataFrame.to_csv`` produces, byte for byte)
  ml_<name>.npy       edge features, row 0 = zeros (sentinel)
  ml_<name>_node.npy  node features, row 0 = zeros (sentinel)

Floats are written as Python's ``repr`` (as pandas writes them), the
shortest text that reads back to the same float64, so timestamps read
back exactly. Not ported yet: the raw CSV parser, the reindexing and the
preprocessing CLI.
"""
from __future__ import annotations

import os

import numpy as np

from .containers import EdgeStream

DATASET_NAMES = [
    "wikipedia", "reddit", "mooc", "lastfm", "myket", "enron", "SocialEvo",
    "uci", "Flights", "CanParl", "USLegis", "UNtrade", "UNvote", "Contacts",
]


def write_processed(
    out_dir: str,
    dataset_name: str,
    stream: EdgeStream,
    edge_feats: np.ndarray,
    node_feats: np.ndarray,
) -> None:
    """Write an already processed stream and its features in the layout above."""
    dest = os.path.join(out_dir, dataset_name)
    os.makedirs(dest, exist_ok=True)
    columns = (stream.src.astype(np.int64).tolist(), stream.dst.astype(np.int64).tolist(),
               stream.ts.astype(np.float64).tolist(), stream.label.astype(np.float64).tolist(),
               stream.eid.astype(np.int64).tolist())
    with open(os.path.join(dest, f"ml_{dataset_name}.csv"), "w") as f:
        f.write(",u,i,ts,label,idx\n")
        f.writelines(f"{k},{u},{i},{ts!r},{label!r},{idx}\n"
                     for k, (u, i, ts, label, idx) in enumerate(zip(*columns)))
    np.save(os.path.join(dest, f"ml_{dataset_name}.npy"), edge_feats)
    np.save(os.path.join(dest, f"ml_{dataset_name}_node.npy"), node_feats)
