#!/usr/bin/env python3
"""Time DyGFormer's eval batch and train step on one card, for one tree of
the port.

    python3 scripts/time_dygformer_steps.py [--repo DIR] [--rounds N]
        [--config CanParl|wikipedia] [--dtypes float32,bfloat16]
        [--modes loop,captured]

``--repo`` names the tree whose ``dyglib_tpu_torch`` is imported (default:
this checkout); run two trees in turns (parent, change, change, parent)
in one command to compare them on one card.

As chip_smoke.py drives them: the published configuration (CanParl:
maxlen 2048, patch 64, with the entry fetch; wikipedia: maxlen 32, patch
1, gathered rows; channel embedding 50, 2 layers, 2 heads, time features
100), seed-0 weights, the wikipedia-scale synthetic stream (157474 edges,
seed 1), B = 200, kernels on, dropout 0, in each compute dtype of
``--dtypes``. ``loop``: ``evaluate`` over the first 10 val batches and
``train_step`` over the last 10 train batches (5 at CanParl);
``captured``: the scan path (``TrainConfig(scan_epochs=True)``, no
sequence buckets): ``train_epoch_scanned`` over those train batches and
``evaluate(scanned=True)`` over those val batches, replaying the CUDA
graphs the warm-up sweep captured. Host clock around each sweep, ending in
a synchronize, after one warm-up sweep; ``--rounds`` sweeps of each, in
turns. Prints the card's name and power limit, the ms per batch and per
step, then one JSON line. Needs a CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, EVAL_BATCHES = 200, 10
CONFIGS = {"CanParl": (2048, 64, 5), "wikipedia": (32, 1, 10)}  # maxlen, patch, train steps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=REPO_ROOT,
                        help="tree whose dyglib_tpu_torch is timed (default: this checkout)")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--config", choices=sorted(CONFIGS), default="CanParl")
    parser.add_argument("--dtypes", default="float32")
    parser.add_argument("--modes", default="loop")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_dygformer_steps: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    from dyglib_tpu_torch.data import synthetic_link_prediction_data
    from dyglib_tpu_torch.graph import NegativeEdgeSampler
    from dyglib_tpu_torch.models import DyGFormer
    from dyglib_tpu_torch.ops import _build
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"timing {os.path.abspath(args.repo)}", flush=True)
    _build.build()
    dev = torch.device("cuda:0")
    data = synthetic_link_prediction_data(num_src=8227, num_dst=1000, num_edges=157474, seed=1)
    maxlen, patch, train_steps = CONFIGS[args.config]
    val = data.val.slice(0, EVAL_BATCHES * B)
    n = data.train.num_interactions
    train = data.train.slice(n - train_steps * B, n)
    result = {}
    for dtype in args.dtypes.split(","):
        for mode in args.modes.split(","):
            captured = mode == "captured"
            backbone = DyGFormer(max_input_sequence_length=maxlen, patch_size=patch,
                                 channel_embedding_dim=50, num_layers=2, num_heads=2,
                                 time_feat_dim=100, dropout=0.0, compute_dtype=dtype,
                                 use_entry_fetch=args.config == "CanParl")
            cfg = (TrainConfig(batch_size=B, learning_rate=1e-4, scan_epochs=True,
                               sequence_buckets=False) if captured
                   else TrainConfig(batch_size=B, learning_rate=1e-4))
            tr = LinkPredictionTrainer(backbone, data, cfg, device=dev)
            tr.init_params(0)
            tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=11)
            batches = [(arrays, bucket) for _, arrays, bucket in tr.train_batches(train)]

            def eval_ms():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses = tr.evaluate(val, tr.val_neg, scanned=captured)[0]
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) / len(losses) * 1e3

            def train_ms():
                tr.train_neg.reset_random_state()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if captured:
                    steps = len(tr.train_epoch_scanned(train)[0])
                else:
                    for arrays, bucket in batches:
                        tr.train_step(arrays, bucket)
                    steps = len(batches)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) / steps * 1e3

            eval_ms(), train_ms()  # warm-up: allocator, cuBLAS, libraries, graph captures
            key = f"{dtype} {mode}"
            result[key] = {"eval_ms_per_batch": [], "train_ms_per_step": []}
            for _ in range(args.rounds):
                result[key]["eval_ms_per_batch"].append(eval_ms())
                result[key]["train_ms_per_step"].append(train_ms())
            for what, values in result[key].items():
                print(f"{args.config} {key} {what} {['%.3f' % v for v in values]}", flush=True)
            del tr
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "repo": os.path.abspath(args.repo), "config": args.config,
                      **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
