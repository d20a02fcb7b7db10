#!/usr/bin/env python3
"""Count the ReLU sign changes in TGAT's training lockstep on one card.

    python3 scripts/tgat_lockstep_flips.py [--repo DIR]

``--repo`` names the tree whose ``dyglib_tpu_torch`` is run (default: this
checkout); the lockstep itself is this checkout's ``chip_smoke.py``'s
(``tgat_lockstep``: its phase 5t's data, seed-0 weights and last train
batches). So an older tree's kernels can be held to their plain versions
by today's count.

For each TGAT kernel configuration, at dropout 0 over the train batches
and for one step at dropout 0.1, the lockstep runs twice: aligned, as
``chip_smoke.py`` compares (the plain path takes the kernel path's value
at each ReLU input that changed sign), and unaligned (the raw gradient
error, each path on its own branch). Prints the card's name and power
limit, one line per run (losses' and gradients' largest differences, the
tensor where the gradient's fell, the sign changes of each ``fc1`` and the
largest |input| among them), then one JSON line. It reports a lockstep
over chip_smoke.py's limits and does not raise for it. Needs a CUDA card.
"""
import argparse
import importlib.util
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=REPO_ROOT,
                        help="tree whose dyglib_tpu_torch is run (default: this checkout)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tgat_lockstep_flips: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO_ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.data import synthetic_link_prediction_data
    from dyglib_tpu_torch.ops import _build

    card = cs.card_line()
    print(card, flush=True)
    print(f"running {os.path.abspath(ops.__file__)}", flush=True)
    _build.build(["temporal_attention", "gathered_attention", "window_attention",
                  "phi_projection"])
    dev = torch.device("cuda:0")
    data = synthetic_link_prediction_data(num_src=8227, num_dst=1000, num_edges=157474, seed=1)
    trainers, params = cs.tgat_trainers(data, dev)
    batches = cs.tgat_train_batches(data, trainers["plain"])
    results = {}
    for name, (_, use_kernels, _) in cs.TGAT_CONFIGS.items():
        if not use_kernels:
            continue
        for dropout, steps in ((0.0, batches), (cs.TGAT_DROPOUT, batches[-1:])):
            for align in (True, False):
                stats = cs.tgat_lockstep(trainers[name], params, steps, dropout, align=align)
                key = f"{name} dropout {dropout} {'aligned' if align else 'unaligned'}"
                results[key] = stats
                print(f"{key}: {json.dumps(stats)}", flush=True)
    print(json.dumps({"card": card, "repo": os.path.abspath(args.repo),
                      "limits": {"loss": cs.LOSS_ATOL, "grad": cs.GRAD_STEP_RTOL,
                                 "flipped_input": cs.FLIP_ATOL},
                      "lockstep": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
