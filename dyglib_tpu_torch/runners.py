"""Experiment runners: DyGLib's four CLI drivers as library functions.

Counterpart of ``dyglib_tpu/runners.py``:
  * ``run_link_prediction_training``: multi-run training with a log per
    run, checkpoints at ./saved_models/{model}/{dataset}/{model}_seed{run}/
    and results JSON at ./saved_results/{model}/{dataset}/, and mean +/-
    sample std over runs;
  * ``run_link_prediction_evaluation``: the saved checkpoints under the
    random, historical or inductive negatives (``build_eval_neg_samplers``:
    val samplers observe up to the end of train, test ones up to the end
    of val), the memory models' val state carried into test, and the
    EdgeBank arm;
  * ``run_node_classification_training`` / ``_evaluation``: the
    frozen-backbone head task, from the link-prediction checkpoint's
    backbone; the evaluation rebuilds a memory model's state by replaying
    train and val when the head checkpoint holds none.

Paths are relative to the working directory, as DyGLib's are. Each
``run_*`` runs on ``device`` (default: the ``--device`` flag, ``cuda``
unless asked otherwise). The link-prediction drivers run over a rank grid
when the parallelism flags ask for one (``setup_parallelism``): one
process per device, ``--num_processes``, ``--process_id`` and
``--coordinator_address`` (rank 0's host:port) on each; only the lead
rank writes results, checkpoints and logs. The node-classification
drivers run on one device, as the JAX package's do. ``--compute_dtype``
goes to ``build_backbone``; the JAX package's ``--fast_prng``, whose
feature the port lacks, raises ``NotImplementedError``.
"""
from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from .configs.factory import build_backbone
from .data.datasets import get_link_prediction_data, get_node_classification_data
from .device import resolve_device
from .graph.neg_sampler import build_eval_neg_samplers
from .parallel import initialize_distributed, make_mesh
from .parallel.distributed import free_port
from .parallel.mesh import broadcast_object
from .train.checkpoints import load_checkpoint, to_device
from .train.edgebank_eval import evaluate_edge_bank_link_prediction
from .train.link_prediction import LinkPredictionTrainer, TrainConfig
from .train.node_classification import NodeClassificationTrainer

LINK_SPLITS = ("validate", "new node validate", "test", "new node test")


def make_run_logger(args, run_name: str, write: bool = True) -> logging.Logger:
    """Per-run file (DEBUG) + console (WARNING) logger under
    ./logs/{model}/{dataset}/{run_name}/ (``write=False``: the console only)."""
    logger = logging.getLogger(run_name)
    logger.setLevel(logging.DEBUG)
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if write:
        log_dir = f"./logs/{args.model_name}/{args.dataset_name}/{run_name}/"
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"{time.time()}.log"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    ch = logging.StreamHandler()
    ch.setLevel(logging.WARNING)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    return logger


def train_config_from_args(args) -> TrainConfig:
    return TrainConfig(
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        optimizer=args.optimizer.lower(),
        patience=args.patience,
        test_interval_epochs=args.test_interval_epochs,
        time_scaling_factor=args.time_scaling_factor,
        head_dropout=args.dropout,
        scan_epochs=args.scan_epochs,
        sequence_buckets=not args.no_sequence_buckets,
        check_memory_order=args.check_memory_order,
        show_progress=args.show_progress,
    )


def refuse_fast_prng(args) -> None:
    if args.fast_prng:
        raise NotImplementedError(
            "--fast_prng picks a JAX PRNG implementation; the port has no counterpart "
            "(its dropout draws from torch.Generator)")


def setup_parallelism(args, device=None):
    """The process group and rank grid the flags ask for -> (mesh | None,
    is_lead). Call once per process before building trainers.

    One process and the default grid (``--data_parallelism 0``,
    ``--model_parallelism 1``) keep the single-device path: (None, True).
    Otherwise ``--num_processes`` ranks (``--process_id`` this one,
    ``--coordinator_address`` rank 0's host:port; a single process makes
    its own one-rank group on a free local port) form a (dp, mp) grid:
    ``dp`` of 0 or -1 is the process count / mp, else dp x mp must equal
    the process count (``ValueError`` otherwise). The backend is NCCL on
    ``cuda`` (each rank on ``cuda:<process_id % device_count>``), gloo on
    the CPU."""
    refuse_fast_prng(args)
    dev = _device(args, device)
    n = args.num_processes
    if n < 1:
        raise ValueError(f"--num_processes {n}: need at least one process")
    dp, mp = args.data_parallelism, args.model_parallelism
    if n == 1 and dp == 0 and mp == 1:
        return None, True
    if mp < 1 or dp < -1:
        raise ValueError(f"--data_parallelism {dp} / --model_parallelism {mp}: dp must be "
                         ">= -1 and mp >= 1")
    if n % mp:
        raise ValueError(f"--model_parallelism {mp} does not divide {n} processes")
    if dp not in (0, -1) and dp * mp != n:
        raise ValueError(f"--data_parallelism {dp} x --model_parallelism {mp} = {dp * mp} "
                         f"ranks, but the run has {n} processes (--num_processes)")
    address = args.coordinator_address or (f"127.0.0.1:{free_port()}" if n == 1 else "")
    rank, _ = initialize_distributed(address, n, args.process_id, device=dev)
    mesh = make_mesh(n, model_parallelism=mp,
                     device=torch.device("cuda", torch.cuda.current_device())
                     if dev.type == "cuda" else dev)
    return mesh, rank == 0


def _device(args, device):
    return resolve_device(device if device is not None else getattr(args, "device", None))


def _save_results(args, run_name: str, results: dict) -> str:
    folder = f"./saved_results/{args.model_name}/{args.dataset_name}"
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"{run_name}.json")
    payload = {
        split: {k: f"{v:.4f}" for k, v in metrics.items()}
        for split, metrics in results.items()
        if isinstance(metrics, dict) and split.endswith("metrics")
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=4)
    return path


def _aggregate(logger, name: str, all_runs: list[dict]) -> dict:
    """{metric: (mean, sample std)} over runs (std 0 for one run)."""
    out = {}
    if not all_runs:
        return out
    for metric in all_runs[0]:
        vals = [r[metric] for r in all_runs]
        mean = float(np.mean(vals))
        std = float(np.std(vals, ddof=1)) if len(vals) > 1 else 0.0
        logger.info(f"average {name} {metric}, {mean:.4f} ± {std:.4f}")
        out[metric] = (mean, std)
    return out


def checkpoint_path(args, run: int, create: bool = True) -> str:
    folder = f"./saved_models/{args.model_name}/{args.dataset_name}/{args.model_name}_seed{run}/"
    if create:
        os.makedirs(folder, exist_ok=True)
    return os.path.join(folder, f"{args.model_name}_seed{run}.pkl")


def head_checkpoint_path(args, run: int) -> str:
    return checkpoint_path(args, run).replace(".pkl", "_node_classification.pkl")


def print_aggregate(aggregate: dict) -> None:
    """The drivers' closing lines: "<split> <metric>: mean ± std"."""
    for split, metrics in aggregate.items():
        for name, (mean, std) in metrics.items():
            print(f"{split} {name}: {mean:.4f} ± {std:.4f}")


def run_link_prediction_training(args, device=None) -> dict:
    """Multi-run training driver; returns aggregate metrics. Under a mesh
    every rank trains; the lead writes the results, checkpoints and logs."""
    mesh, is_lead = setup_parallelism(args, device)
    dev = mesh.device if mesh is not None else _device(args, device)
    data = get_link_prediction_data(
        args.dataset_name, args.val_ratio, args.test_ratio, args.data_root
    )
    cfg = train_config_from_args(args)
    aggregates = {k: [] for k in LINK_SPLITS}
    logger = None
    for run in range(args.num_runs):
        run_name = f"{args.model_name}_seed{run}"
        logger = make_run_logger(args, run_name, write=is_lead)
        logger.info(f"********** Run {run + 1} starts. **********")
        logger.info(f"configuration is {args}")
        t0 = time.time()
        trainer = LinkPredictionTrainer(
            build_backbone(args, data), data, cfg, checkpoint_path(args, run, create=is_lead),
            device=dev, mesh=mesh)
        results = trainer.fit(seed=run, log=logger.info)
        for split in aggregates:
            aggregates[split].append(results[f"{split} metrics"])
            for k, v in results[f"{split} metrics"].items():
                logger.info(f"{split} {k}, {v:.4f}")
        logger.info(f"Run {run + 1} cost {time.time() - t0:.2f} seconds.")
        if is_lead:
            _save_results(args, run_name, results)
    logger.info(f"metrics over {args.num_runs} runs:")
    return {split: _aggregate(logger, split, runs) for split, runs in aggregates.items()}


def run_link_prediction_evaluation(args, device=None) -> dict:
    """Evaluate saved checkpoints under a negative-sampling strategy,
    including the EdgeBank arm (on one device). Under a mesh the lead
    reads each checkpoint and sends it to the other ranks, and writes the
    results."""
    if args.model_name == "EdgeBank":
        refuse_fast_prng(args)
        mesh, is_lead = None, True
    else:
        mesh, is_lead = setup_parallelism(args, device)
    dev = mesh.device if mesh is not None else _device(args, device)
    data = get_link_prediction_data(
        args.dataset_name, args.val_ratio, args.test_ratio, args.data_root
    )
    cfg = train_config_from_args(args)
    val_neg, nn_val_neg, test_neg, nn_test_neg = build_eval_neg_samplers(
        data, args.negative_sample_strategy)

    if args.model_name == "EdgeBank":
        all_runs = []
        logger = None
        for run in range(args.num_runs):
            run_name = f"{args.negative_sample_strategy}_negative_sampling_EdgeBank_seed{run}"
            logger = make_run_logger(args, run_name)
            _, test_metrics = evaluate_edge_bank_link_prediction(
                data, test_neg, args.batch_size, args.edge_bank_memory_mode,
                args.time_window_mode, args.test_ratio, device=dev,
            )
            md = LinkPredictionTrainer.mean_metrics(test_metrics)
            for k, v in md.items():
                logger.info(f"test {k}, {v:.4f}")
            all_runs.append(md)
            _save_results(args, run_name, {"test metrics": md})
        return {"test": _aggregate(logger, "test", all_runs)}

    aggregates = {k: [] for k in LINK_SPLITS}
    logger = None
    for run in range(args.num_runs):
        run_name = f"{args.negative_sample_strategy}_negative_sampling_{args.model_name}_seed{run}"
        logger = make_run_logger(args, run_name, write=is_lead)
        backbone = build_backbone(args, data)
        path = checkpoint_path(args, run, create=is_lead)
        trainer = LinkPredictionTrainer(backbone, data, cfg, path, device=dev, mesh=mesh)
        ckpt = load_checkpoint(path) if is_lead else None
        if mesh is not None:
            ckpt = broadcast_object(ckpt, mesh, "checkpoint/load")
        trainer.load_params(ckpt["params"])
        state = trainer.load_state(ckpt["state"])
        # val and new-node val from the checkpoint's state, test and
        # new-node test from the state after val
        val = trainer.evaluate(data.val, val_neg, 0, state=state)
        val_state = val[3] if trainer.has_state else None
        sweeps = {
            "validate": val[1],
            "new node validate": trainer.evaluate(data.new_node_val, nn_val_neg, 1,
                                                  state=state)[1],
            "test": trainer.evaluate(data.test, test_neg, 2, state=val_state)[1],
            "new node test": trainer.evaluate(data.new_node_test, nn_test_neg, 3,
                                              state=val_state)[1],
        }
        per_split = {split: trainer.mean_metrics(m) for split, m in sweeps.items()}
        for split, md in per_split.items():
            aggregates[split].append(md)
            for k, v in md.items():
                logger.info(f"{split} {k}, {v:.4f}")
        if is_lead:
            _save_results(args, run_name, {f"{s} metrics": m for s, m in per_split.items()})
    return {split: _aggregate(logger, split, runs) for split, runs in aggregates.items()}


def run_node_classification_training(args, device=None) -> dict:
    """Frozen-backbone head training from each run's link-prediction
    checkpoint, on one device (the JAX package's driver takes no mesh)."""
    refuse_fast_prng(args)
    dev = _device(args, device)
    link_data = get_link_prediction_data(
        args.dataset_name, args.val_ratio, args.test_ratio, args.data_root
    )
    nc_data = get_node_classification_data(
        args.dataset_name, args.val_ratio, args.test_ratio, args.data_root
    )
    cfg = train_config_from_args(args)
    all_val, all_test = [], []
    logger = None
    for run in range(args.num_runs):
        run_name = f"node_classification_{args.model_name}_seed{run}"
        logger = make_run_logger(args, run_name)
        backbone = build_backbone(args, link_data)
        ckpt = load_checkpoint(checkpoint_path(args, run))
        trainer = NodeClassificationTrainer(
            backbone, nc_data, cfg, head_checkpoint_path(args, run),
            ckpt["params"]["backbone"], device=dev,
        )
        results = trainer.fit(seed=run, log=logger.info)
        all_val.append(results["validate metrics"])
        all_test.append(results["test metrics"])
        _save_results(args, run_name, results)
    return {
        "validate": _aggregate(logger, "validate", all_val),
        "test": _aggregate(logger, "test", all_test),
    }


def run_node_classification_evaluation(args, device=None) -> dict:
    """Evaluate saved node-classification heads on the test split, on one
    device."""
    refuse_fast_prng(args)
    dev = _device(args, device)
    link_data = get_link_prediction_data(
        args.dataset_name, args.val_ratio, args.test_ratio, args.data_root
    )
    nc_data = get_node_classification_data(
        args.dataset_name, args.val_ratio, args.test_ratio, args.data_root
    )
    cfg = train_config_from_args(args)
    all_test = []
    logger = None
    for run in range(args.num_runs):
        run_name = f"evaluate_node_classification_{args.model_name}_seed{run}"
        logger = make_run_logger(args, run_name)
        backbone = build_backbone(args, link_data)
        bk_ckpt = load_checkpoint(checkpoint_path(args, run))
        head_ckpt = load_checkpoint(head_checkpoint_path(args, run))
        trainer = NodeClassificationTrainer(
            backbone, nc_data, cfg, None, bk_ckpt["params"]["backbone"], device=dev)
        trainer.load_head(head_ckpt["params"])
        state = to_device(head_ckpt["state"], dev)
        # a memory model's head checkpoint normally holds the post-val
        # memory; without it, replay train and val chronologically (every
        # edge commits) so that test never runs on a cold memory
        if trainer.has_state and state is None:
            logger.warning(
                "checkpoint has no memory state — replaying train+val "
                "chronologically to warm memory before test"
            )
            _, state = trainer.evaluate(nc_data.train, state=trainer.init_state(), salt=2)
            _, state = trainer.evaluate(nc_data.val, state=state, salt=3)
        test_metrics, _ = trainer.evaluate(nc_data.test, state=state, salt=1)
        for k, v in test_metrics.items():
            logger.info(f"test {k}, {v:.4f}")
        all_test.append(test_metrics)
        _save_results(args, run_name, {"test metrics": test_metrics})
    return {"test": _aggregate(logger, "test", all_test)}
