"""CLI argument schemas for the two tasks.

Counterpart of ``dyglib_tpu/configs/args.py``: the same flags, defaults
and choices (DyGLib's utils/load_configs.py:6-66 and :239-289), plus
``--device`` (default ``cuda``, resolved by ``device.resolve_device``;
``cpu`` runs on the CPU, as the tests do). The JAX package's scale-out
flags build a rank grid (``runners.setup_parallelism``: one process per
device). ``--compute_dtype bfloat16`` runs TGAT, CAWN and DyGFormer in
bf16, as in the JAX package. Its TPU flag whose feature the port lacks
(``--fast_prng``) raises ``NotImplementedError`` when set, never ignored.
"""
from __future__ import annotations

import argparse

from ..data.preprocess import DATASET_NAMES
from .best_configs import (
    load_link_prediction_best_configs,
    load_node_classification_best_configs,
)

MODEL_NAMES = [
    "JODIE", "DyRep", "TGAT", "TGN", "CAWN", "EdgeBank", "TCL",
    "GraphMixer", "DyGFormer",
]


def _validate_dataset_name(args) -> None:
    """Reference constrains --dataset_name to the 14 published names
    (load_configs.py:14-15). With a custom --data_root (our extension for
    user-supplied processed datasets) any name is accepted."""
    if args.data_root == "./processed_data" and args.dataset_name not in DATASET_NAMES:
        raise SystemExit(
            f"unknown --dataset_name {args.dataset_name!r}; expected one of "
            f"{DATASET_NAMES} (or pass --data_root for a custom dataset)"
        )


def _common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--batch_size", type=int, default=200)
    parser.add_argument("--num_neighbors", type=int, default=20)
    parser.add_argument(
        "--sample_neighbor_strategy", type=str, default="recent",
        choices=["uniform", "recent", "time_interval_aware"],
    )
    parser.add_argument("--time_scaling_factor", type=float, default=1e-6)
    parser.add_argument("--num_walk_heads", type=int, default=8)
    parser.add_argument("--num_heads", type=int, default=2)
    parser.add_argument("--num_layers", type=int, default=2)
    parser.add_argument("--walk_length", type=int, default=1)
    parser.add_argument("--time_gap", type=int, default=2000)
    parser.add_argument("--time_feat_dim", type=int, default=100)
    parser.add_argument("--position_feat_dim", type=int, default=172)
    parser.add_argument("--patch_size", type=int, default=1)
    parser.add_argument("--channel_embedding_dim", type=int, default=50)
    parser.add_argument("--max_input_sequence_length", type=int, default=32)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--dropout", type=float, default=0.1)
    parser.add_argument("--num_epochs", type=int, default=100)
    parser.add_argument(
        "--optimizer", type=str, default="Adam", choices=["SGD", "Adam", "RMSprop"]
    )
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--patience", type=int, default=20)
    parser.add_argument("--val_ratio", type=float, default=0.15)
    parser.add_argument("--test_ratio", type=float, default=0.15)
    parser.add_argument("--num_runs", type=int, default=5)
    parser.add_argument("--test_interval_epochs", type=int, default=10)
    parser.add_argument("--load_best_configs", action="store_true", default=False)
    parser.add_argument(
        "--data_root", type=str, default="./processed_data",
        help="directory containing processed datasets",
    )
    # --- the JAX package's scale-out flags (no DyGLib equivalent)
    parser.add_argument(
        "--scan_epochs", action="store_true", default=False,
        help="stage each train epoch and eval sweep at once and replay its "
        "steps as CUDA graphs",
    )
    parser.add_argument(
        "--no_sequence_buckets", action="store_true", default=False,
        help="disable per-batch sequence-length buckets (DyGFormer)",
    )
    parser.add_argument(
        "--check_memory_order", action="store_true", default=False,
        help="validation mode: verify node memory clocks never move "
        "backwards after each train step (memory models)",
    )
    parser.add_argument(
        "--data_parallelism", type=int, default=0,
        help="ranks on the mesh data axis (0 with one process = single device; "
        "0 or -1 = processes / model_parallelism)",
    )
    parser.add_argument(
        "--model_parallelism", type=int, default=1,
        help="ranks on the mesh model axis (feature columns, DyGFormer's "
        "sequence axis)",
    )
    parser.add_argument(
        "--coordinator_address", type=str, default="",
        help="rank 0's host:port for the process group's TCP store",
    )
    parser.add_argument(
        "--num_processes", type=int, default=1,
        help="processes of the run, one per device",
    )
    parser.add_argument(
        "--process_id", type=int, default=0,
        help="this process's rank",
    )
    parser.add_argument(
        "--compute_dtype", type=str, default="float32",
        choices=["float32", "bfloat16"],
        help="compute dtype of TGAT, CAWN and DyGFormer (parameters stay float32; "
        "the other models ignore it)",
    )
    parser.add_argument(
        "--show_progress", action="store_true", default=False,
        help="live per-batch train-loss line on stderr (link-prediction "
        "training)",
    )
    parser.add_argument(
        "--fast_prng", action="store_true", default=False,
        help="the JAX package's hardware PRNG for dropout masks (no "
        "counterpart in the port: raises)",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to run on (cuda by default; cpu for tests)",
    )


def get_link_prediction_args(
    argv: list[str] | None = None, is_evaluation: bool = False
) -> argparse.Namespace:
    parser = argparse.ArgumentParser("Interface for the link prediction task")
    parser.add_argument(
        "--dataset_name", type=str, default="wikipedia",
    )
    parser.add_argument(
        "--model_name", type=str, default="DyGFormer", choices=MODEL_NAMES
    )
    _common_args(parser)
    parser.add_argument(
        "--edge_bank_memory_mode", type=str, default="unlimited_memory",
        choices=["unlimited_memory", "time_window_memory", "repeat_threshold_memory"],
    )
    parser.add_argument(
        "--time_window_mode", type=str, default="fixed_proportion",
        choices=["fixed_proportion", "repeat_interval"],
    )
    parser.add_argument(
        "--negative_sample_strategy", type=str, default="random",
        choices=["random", "historical", "inductive"],
    )
    args = parser.parse_args(argv)

    _validate_dataset_name(args)
    if args.model_name == "EdgeBank":
        assert is_evaluation, "EdgeBank is only applicable for evaluation!"
    if args.load_best_configs:
        load_link_prediction_best_configs(args)
    return args


def get_node_classification_args(
    argv: list[str] | None = None,
) -> argparse.Namespace:
    parser = argparse.ArgumentParser("Interface for the node classification task")
    parser.add_argument("--dataset_name", type=str, default="wikipedia")
    parser.add_argument(
        "--model_name", type=str, default="DyGFormer",
        choices=[m for m in MODEL_NAMES if m != "EdgeBank"],
    )
    _common_args(parser)
    args = parser.parse_args(argv)
    _validate_dataset_name(args)
    if args.load_best_configs:
        load_node_classification_best_configs(args)
    return args
