"""The readings a cell's limits are set from, in one process.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]
        [--witness-seeds 1,2] [--root DIR]

For each seed: the cell's set-up and one sweep of its window, then the
numbers its check compares for the program (the lower readings), and for
each control seed the same numbers for the reference put in the
program's place in TF32 (the control) and, in a train cell, with half of
each batch left out or with the sweep's steps given the batch before
their own (faults), and, under a random sample strategy, drawing its
neighbours from the seed after the program's (``other_draws``). Each is
judged against the cell's limits by the run's own ``harness.judge``, so a
control's ``correct`` is the one a run would print. A train cell's check here also follows the set-up's whole
sweep, and for each witness seed the reference started one rounding
away from the starting parameters stands beside the program: how far
rounding alone carries each reading. Under a random strategy each seed
also counts the sampled entries where the port's sampler and the
reference's differ (``pick_differences``; 0 expected). ``--root``: a
benchmark root other than this one (cells kept out of the manifest). One
JSON line each; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def readings(gaps: dict) -> dict:
    """The other readings of a train check, to judge which numbers are steady."""
    import statistics

    from port_bench import harness

    worst = lambda d: max(d, key=d.get)
    out = {"loss_each_step": gaps["loss"], "grad_worst_leaf": worst(gaps["grad"]),
           "sweep_loss_gap": max(gaps["loss"][harness.FIRST_STEPS:]),
           "sweep_change_gap": statistics.median(gaps["change.sweep"].values())}
    for when in ("first", "sweep"):
        d = gaps[f"change.{when}"]
        out.update({f"change_{when}_worst": max(d.values()), f"change_{when}_worst_leaf": worst(d)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--root", default=None)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from port_bench import catalog, harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    cell = catalog.cell(args.workload, Path(args.root) if args.root else catalog.ROOT)
    random_draws = cell["cfg"].get("sample_neighbor_strategy", "recent") != "recent"
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    witnesses = {int(s) for s in args.witness_seeds.split(",") if s}
    for seed in seeds:
        run = harness.Run(cell, seed, 0.0, "cuda")
        run.follow_sweep = True
        t0 = time.perf_counter()
        run.setup()
        stats = run.window()
        peak = torch.cuda.max_memory_allocated()
        picks = {"pick_differences": run.pick_differences()} if random_draws else {}
        run.free_program()
        t1 = time.perf_counter()
        rows = [("program", run.gaps())]
        t2 = time.perf_counter()
        if seed in controls:
            rows.append(("tf32", run.gaps("tf32")))
            if random_draws:
                rows.append(("other_draws", run.gaps("other_draws")))
            if run.phase == "train":
                rows += [(fault, run.gaps(fault)) for fault in ("half_batch", "shifted_rows")]
        if seed in witnesses and run.phase == "train":
            rows.append(("one_ulp", run.gaps("one_ulp")))
        for kind, gaps in rows:
            numbers = harness.train_numbers(gaps) if run.phase == "train" else gaps
            judged = harness.judge(cell, stats, numbers)[0] and run.layout_note() is None
            out = {"workload": args.workload, "seed": seed, "kind": kind, "correct": judged,
                   **numbers}
            if run.phase == "train":
                out["readings"] = readings(gaps)
            out.update(setup_window_s=t1 - t0, check_s=t2 - t1, peak_bytes=peak, **picks)
            print(json.dumps(out), flush=True)
        del run
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
