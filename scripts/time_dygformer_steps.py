#!/usr/bin/env python3
"""Time DyGFormer CanParl's eval batch and train step on one card, for one
tree of the port.

    python3 scripts/time_dygformer_steps.py [--repo DIR] [--rounds N]

``--repo`` names the tree whose ``dyglib_tpu_torch`` is imported (default:
this checkout); run two trees in turns (parent, change, change, parent)
in one command to compare them on one card.

As chip_smoke.py drives them: the published CanParl configuration
(maxlen 2048, patch 64, channel embedding 50, 2 layers, 2 heads, time
features 100), seed-0 weights, the wikipedia-scale synthetic stream
(157474 edges, seed 1), B = 200, kernels on. Eval: ``evaluate`` over the
first 10 val batches; train: ``train_step`` over the last 5 train batches
with the entry fetch, dropout 0. Host clock around each sweep, ending in a
synchronize, after one warm-up sweep; ``--rounds`` sweeps of each, in
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
B, EVAL_BATCHES, TRAIN_STEPS = 200, 10, 5


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=REPO_ROOT,
                        help="tree whose dyglib_tpu_torch is timed (default: this checkout)")
    parser.add_argument("--rounds", type=int, default=3)
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
    backbone = DyGFormer(max_input_sequence_length=2048, patch_size=64, channel_embedding_dim=50,
                         num_layers=2, num_heads=2, time_feat_dim=100, dropout=0.0,
                         use_entry_fetch=True)
    tr = LinkPredictionTrainer(backbone, data, TrainConfig(batch_size=B, learning_rate=1e-4),
                               device=dev)
    tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=11)
    val = data.val.slice(0, EVAL_BATCHES * B)
    n = data.train.num_interactions
    batches = [(arrays, bucket) for _, arrays, bucket in
               tr.train_batches(data.train.slice(n - TRAIN_STEPS * B, n))]

    def eval_ms():
        tr.init_params(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.evaluate(val, tr.val_neg)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / EVAL_BATCHES * 1e3

    def train_ms():
        tr.init_params(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for arrays, bucket in batches:
            tr.train_step(arrays, bucket)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / len(batches) * 1e3

    eval_ms(), train_ms()  # warm-up: allocator, cuBLAS, the kernels' libraries
    result = {"eval_ms_per_batch": [], "train_ms_per_step": []}
    for _ in range(args.rounds):
        result["eval_ms_per_batch"].append(eval_ms())
        result["train_ms_per_step"].append(train_ms())
    for key, values in result.items():
        print(f"CanParl {key} {['%.3f' % v for v in values]}", flush=True)
    print(json.dumps({"card": card, "repo": os.path.abspath(args.repo), **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
