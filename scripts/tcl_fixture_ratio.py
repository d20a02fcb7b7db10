#!/usr/bin/env python3
"""The spread of TCL's fixture-fit check over train-negative streams.

    python3 scripts/tcl_fixture_ratio.py [--seeds 0-49] [--device cuda|cpu]

``chip_smoke.py`` phase 6n holds TCL to the JAX test's training signal
(tests/test_remaining_models.py::test_tcl_end_to_end): on the 2000-edge
test fixture (seed 7), TCL K = 10, 2 layers, weights and dropout from seed
0, lr 1e-3, four ``train_epoch``s; the last epoch's mean loss must be below
0.93 x the first's and below 0.69. Its train negatives come from a sampler;
this script runs that protocol once for each seed of a seeded sampler and
prints, per seed, the four epoch means, the last / first ratio and whether
the check passes, then the pass count.
"""
import argparse
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seed_range(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=seed_range, default=seed_range("0-49"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    sys.path.insert(0, REPO_ROOT)
    import numpy as np

    from dyglib_tpu_torch.data import synthetic_link_prediction_data
    from dyglib_tpu_torch.graph import NegativeEdgeSampler
    from dyglib_tpu_torch.models import TCL
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    data = synthetic_link_prediction_data(num_src=120, num_dst=60, num_edges=2000,
                                          node_feat_scale=1.0, seed=7)
    passed = 0
    for seed in args.seeds:
        tr = LinkPredictionTrainer(
            TCL(num_neighbors=10, num_layers=2), data,
            TrainConfig(batch_size=200, num_epochs=4, learning_rate=1e-3), device=args.device)
        tr.init_params(0)
        tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=seed)
        means = [float(np.mean(tr.train_epoch()[0])) for _ in range(4)]
        ok = means[-1] < 0.93 * means[0] and means[-1] < 0.69
        passed += ok
        print(json.dumps({"seed": seed, "epoch_means": means, "ratio": means[-1] / means[0],
                          "pass": ok}), flush=True)
    print(json.dumps({"device": args.device, "seeds": len(args.seeds), "passed": passed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
