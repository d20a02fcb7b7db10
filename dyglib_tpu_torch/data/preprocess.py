"""Raw CSV -> the processed-dataset layout that every loader reads.

Counterpart of ``dyglib_tpu/data/preprocess.py`` (reference
preprocess_data/preprocess_data.py:9-177), written with the ``csv``
module and numpy, without pandas. Input (``DG_data/<name>/<name>.csv``):
a header line, then ``src,dst,ts,label,feat...`` rows with
non-decreasing ``ts``. Output, under ``<out_dir>/<name>/``:

  ml_<name>.csv       the edge list: pandas' unnamed index column, then
                      u, i, ts, label, idx (what the JAX writer's
                      ``DataFrame.to_csv`` produces, byte for byte)
  ml_<name>.npy       edge features (float64), row 0 = zeros (sentinel)
  ml_<name>_node.npy  node features (float64), (max id + 1, node_feat_dim)
                      zeros

Reindexing: a bipartite graph's destination ids are shifted past the
source id range; every node id and edge id is shifted by 1, so that id 0
is the padding sentinel. Floats are written as Python's ``repr`` (as
pandas writes them), the shortest text that reads back to the same
float64.

  python -m dyglib_tpu_torch.data.preprocess --dataset_name wikipedia
  python -m dyglib_tpu_torch.data.preprocess --all
"""
from __future__ import annotations

import argparse
import csv
import math
import os

import numpy as np

from .containers import EdgeStream

BIPARTITE_DATASETS = {"wikipedia", "reddit", "mooc", "lastfm", "myket"}
DATASET_NAMES = [
    "wikipedia", "reddit", "mooc", "lastfm", "myket", "enron", "SocialEvo",
    "uci", "Flights", "CanParl", "USLegis", "UNtrade", "UNvote", "Contacts",
]


_POW10 = [float(f"1e{k}") for k in range(309)]


def parse_float(text: str) -> float:
    """A decimal field read as pandas' default C parser reads it (its
    ``precise_xstrtod``: at most 17 significant digits gathered in a
    double, then one multiplication or division by a power of ten), so
    that the outputs equal the JAX writer's bit for bit. That is not
    always Python's correctly rounded ``float()``: the two differ by an
    ulp on some 17-digit fields. Anything else (nan, inf) goes to
    ``float()``."""
    s = text.strip()
    i, n = 0, len(s)
    neg = i < n and s[i] == "-"
    i += i < n and s[i] in "+-"
    number, exponent, digits = 0.0, 0, 0
    while i < n and s[i].isdigit():
        if digits < 17:
            number, digits = number * 10.0 + (ord(s[i]) - 48), digits + 1
        else:
            exponent += 1
        i += 1
    if i < n and s[i] == ".":
        i += 1
        while i < n and s[i].isdigit() and digits < 17:
            number, digits, exponent = number * 10.0 + (ord(s[i]) - 48), digits + 1, exponent - 1
            i += 1
        while i < n and s[i].isdigit():
            i += 1
    if i < n and s[i] in "eE" and digits:
        i += 1
        eneg = i < n and s[i] == "-"
        i += i < n and s[i] in "+-"
        e, start = 0, i
        while i < n and s[i].isdigit():
            e, i = e * 10 + (ord(s[i]) - 48), i + 1
        if i == start:
            return float(text)
        exponent += -e if eneg else e
    if digits == 0 or i != n:
        return float(text)
    number = -number if neg else number
    if exponent > 308:
        return -math.inf if neg else math.inf
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return -0.0 if neg else 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _int(text: str) -> int:
    try:
        return int(text)
    except ValueError:
        return int(parse_float(text))  # "3.0": pandas reads a float, astype truncates


def parse_raw_csv(path: str) -> tuple[EdgeStream, np.ndarray]:
    """A raw edge list (header skipped) -> (stream, edge features).

    Columns u, i, ts, label, then any number of edge-feature columns (one
    zero column when there are none); edge idx = the 0-based row number.
    Raises unless the timestamps are non-decreasing."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f)][1:]
    u = np.array([_int(r[0]) for r in rows], dtype=np.int64)
    i = np.array([_int(r[1]) for r in rows], dtype=np.int64)
    ts = np.array([parse_float(r[2]) for r in rows], dtype=np.float64)
    label = np.array([parse_float(r[3]) for r in rows], dtype=np.float64)
    width = max((len(r) for r in rows), default=4) - 4
    # column-major, as a pandas frame's values are: np.save records the
    # order, and the files are compared byte for byte
    feats = np.asfortranarray(np.array([[parse_float(x) for x in r[4:]] for r in rows],
                                       dtype=np.float64).reshape(len(rows), width))
    if width == 0:
        feats = np.zeros((len(rows), 1), dtype=np.float64)
    if np.any(np.diff(ts) < 0):
        raise ValueError("timestamps must be in ascending order")
    stream = EdgeStream(src=u, dst=i, ts=ts, eid=np.arange(len(u), dtype=np.int64), label=label)
    return stream, feats


def reindex(stream: EdgeStream, bipartite: bool = True) -> EdgeStream:
    """Ids shifted so that 0 is the sentinel; a bipartite graph's destination
    ids moved past its source ids (the reference's contiguity checks
    included)."""
    u, i = stream.src, stream.dst
    if bipartite:
        if u.max() - u.min() + 1 != len(np.unique(u)) or i.max() - i.min() + 1 != len(np.unique(i)):
            raise ValueError("bipartite ids must be contiguous on each side")
        if not u.min() == i.min() == 0:
            raise ValueError("bipartite ids must start at 0 on each side")
        i = i + u.max() + 1
    return EdgeStream(src=u + 1, dst=i + 1, ts=stream.ts, eid=stream.eid + 1, label=stream.label)


def preprocess_dataset(
    raw_csv_path: str,
    out_dir: str,
    dataset_name: str,
    bipartite: bool = True,
    node_feat_dim: int = 172,
) -> None:
    """ml_<name>.csv / .npy / _node.npy under ``out_dir/<name>/``: edge
    features with a zero row 0, all-zero node features of shape
    (max id + 1, node_feat_dim)."""
    stream, edge_feats = parse_raw_csv(raw_csv_path)
    stream = reindex(stream, bipartite=bipartite)
    edge_feats = np.vstack([np.zeros((1, edge_feats.shape[1])), edge_feats])
    max_idx = max(stream.src.max(), stream.dst.max())
    write_processed(out_dir, dataset_name, stream, edge_feats,
                    np.zeros((max_idx + 1, node_feat_dim)))


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


def main(argv: list[str] | None = None) -> None:
    """One dataset (``--dataset_name``) or every one of DATASET_NAMES
    (``--all``, which reports and skips those whose raw CSV is missing)."""
    parser = argparse.ArgumentParser("Preprocess raw dynamic-graph datasets")
    parser.add_argument("--dataset_name", type=str, default=None, choices=DATASET_NAMES,
                        help="one dataset to preprocess")
    parser.add_argument("--all", action="store_true",
                        help="preprocess every dataset in DATASET_NAMES")
    parser.add_argument("--data_root", type=str, default="./DG_data",
                        help="directory holding <name>/<name>.csv raw files")
    parser.add_argument("--out_root", type=str, default="./processed_data")
    parser.add_argument("--node_feat_dim", type=int, default=172)
    args = parser.parse_args(argv)
    if args.all == (args.dataset_name is not None):
        parser.error("exactly one of --dataset_name or --all is required")
    for name in DATASET_NAMES if args.all else [args.dataset_name]:
        raw = os.path.join(args.data_root, name, f"{name}.csv")
        if not os.path.exists(raw):
            msg = f"{name}: raw file not found at {raw}"
            if args.all:
                print(f"skip {msg}")
                continue
            parser.error(msg)
        preprocess_dataset(raw, args.out_root, name, bipartite=name in BIPARTITE_DATASETS,
                           node_feat_dim=args.node_feat_dim)
        print(f"processed {name} -> {os.path.join(args.out_root, name)}")


def _read_processed_csv(path: str) -> tuple[list[str], np.ndarray]:
    with open(path, newline="") as f:
        header = next(csv.reader(f))
    return header, np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64, ndmin=2)


def check_processed(reference_dir: str, out_dir: str, dataset_name: str) -> None:
    """Golden-file check (reference check_data(), preprocess_data.py:120-150),
    as the JAX package's ``assert_frame_equal`` makes it: the same columns,
    the integer columns equal, ts and label within rtol 1e-5 / atol 1e-8;
    the feature files of equal shape, max and min. Raises AssertionError."""
    name = f"ml_{dataset_name}"
    (h_ref, ref), (h_out, out) = (_read_processed_csv(os.path.join(d, dataset_name, f"{name}.csv"))
                                  for d in (reference_dir, out_dir))
    assert h_ref == h_out, f"columns differ: {h_ref} vs {h_out}"
    assert ref.shape == out.shape, f"edge lists differ in shape: {ref.shape} vs {out.shape}"
    for k, col in enumerate(h_ref):
        if col in ("ts", "label"):
            np.testing.assert_allclose(out[:, k], ref[:, k], rtol=1e-5, atol=1e-8, err_msg=col)
        else:
            np.testing.assert_array_equal(out[:, k], ref[:, k], err_msg=col or "index")
    for suffix in ("", "_node"):
        a = np.load(os.path.join(reference_dir, dataset_name, f"{name}{suffix}.npy"))
        b = np.load(os.path.join(out_dir, dataset_name, f"{name}{suffix}.npy"))
        assert a.shape == b.shape and a.max() == b.max() and a.min() == b.min(), (
            f"{name}{suffix}.npy differs")


if __name__ == "__main__":
    main()
