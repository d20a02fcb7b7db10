#!/usr/bin/env python3
"""Where the time of the PyTorch port's evaluation or training goes, on one card.

    python3 scripts/profile_torch_eval.py [--model dygformer|tgat] [--mode eval|train]
                                          [--batches 10] [--configs NAMES] [--repo DIR]

Same setting as chip_smoke.py (synthetic wikipedia-scale stream, seed 1;
random weights, seed 0; B = 200). DyGFormer: the wikipedia (maxlen 32,
patch 1) and CanParl (maxlen 2048, patch 64) configurations, kernel path.
TGAT: the published widths (K = 20, 2 layers, 2 heads, Dt = 100), the
default kernel path (gathered attention at layer 1, fused attention at
layer 2; in training their backward kernels too), the plain path and the
Phi fusion (``use_phi_fusion=True``: the Phi projection's kernels, two a
convolution). ``--configs`` picks configurations by name (comma-separated,
e.g. "TGAT Phi fusion"); ``--repo`` names the tree whose
``dyglib_tpu_torch`` is run (default: this checkout), so that two trees
run by one command in turns compare on one card. For each configuration
it first times the same sweep twice with no profiler (host clock, ending
in a synchronize: ``ms_per_batch``), then traces, with torch.profiler, one
``evaluate`` sweep over the first val batches (``--mode eval``, random val
negatives) or one ``train_epoch`` over the last train batches (``--mode
train``, dropout 0.1; wikipedia on the gather path, CanParl with the entry
fetch, as chip_smoke.py drives them), and reports:

  * per batch, the host time and the device time of each of the loop's
    own profiler ranges. evaluate: ``eval/staging`` (negative draw, bucket
    pick, host-to-device copies), ``eval/sample`` (``DyGFormer.sample``),
    ``eval/forward`` (the network), ``eval/head`` (head + loss) and
    ``eval/metrics`` (copy-back, which waits for the device, + metrics);
    for TGAT ``eval/sample`` is ``TGAT.sample`` (the multi-hop fan-out).
    train_step: ``train/sample``, ``train/forward`` (network, with the
    entry fetch where it runs, head and loss), ``train/backward`` and
    ``train/optimizer`` (Adam).
    A range's device time is that of the kernels launched, from any host
    thread, while the range was open: autograd launches the backward's
    kernels from its own thread, outside the range's child ops;
  * the device busy share of the window (the union of device kernel
    intervals over the wall time), and the ten device kernels and the ten
    PyTorch ops with the most self device time. The profiler also draws
    each range (and the optimizer's step range) on the device timeline;
    those spans are not device work and are left out of both.

First it prints the host cost of one profiler range with no profiler
running (evaluate opens five per batch, train_step four), then one JSON
line per configuration. Needs a CUDA card; raises if the profiler records no
device time.
"""
import argparse
import json
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 200
CONFIGS = (("wikipedia", 32, 1), ("CanParl", 2048, 64))
# (name, TGAT arguments, use_kernels)
TGAT_CONFIGS = (("TGAT default", {}, True), ("TGAT plain", {}, False),
                ("TGAT Phi fusion", {"use_phi_fusion": True}, True))


def is_range(name: str) -> bool:
    """One of the loops' own profiler ranges."""
    return name.startswith(("eval/", "train/"))


def is_span(name: str) -> bool:
    """A range drawn on the device timeline that is not device work: the
    loops' ranges and the optimizer's own step range."""
    return is_range(name) or name.startswith("Optimizer.")


def range_cost_us(n: int = 20000) -> float:
    """Host microseconds to open and close one profiler range, unprofiled."""
    from torch.profiler import record_function

    t0 = time.perf_counter()
    for _ in range(n):
        with record_function("eval/cost"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def phase_device_ms(prof) -> dict[str, float]:
    """Device ms of each range: the kernels and copies whose host launch
    call fell inside one of the range's host intervals."""
    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    cpu = [e for e in evs if e.device_type() == DeviceType.CPU]
    ranges = [(e.name(), e.start_ns(), e.end_ns()) for e in cpu if is_range(e.name())]
    launched = {e.correlation_id(): e.start_ns() for e in cpu if e.name().startswith("cu")}
    out = {name: 0.0 for name, _, _ in ranges}
    for e in evs:
        if e.device_type() != DeviceType.CUDA or is_span(e.name()):
            continue
        t = launched.get(e.correlation_id(), launched.get(e.linked_correlation_id()))
        for name, start, end in ranges:
            if t is not None and start <= t <= end:
                out[name] += e.duration_ns() / 1e6
                break
    return out


def device_profile(run) -> dict:
    """Trace ``run()`` (which ends in a synchronize)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    intervals = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not is_span(e.name)
        and e.time_range.end > e.time_range.start
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:  # union of device intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    self_dev = lambda e: getattr(e, "self_device_time_total", 0.0)
    rows = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    device_ms = phase_device_ms(prof)
    phases = {
        e.key: {
            "host_ms_per_batch": e.cpu_time_total / e.count / 1e3,
            "device_ms_per_batch": device_ms.get(e.key, 0.0) / e.count,
        }
        for e in rows
        if is_range(e.key) and e.device_type != cuda
    }
    if not phases:
        raise RuntimeError("the trace holds none of the loop's eval/* or train/* ranges")
    if not any(device_ms.values()):
        raise RuntimeError("no device time could be tied to a range's launches")
    kernels = sorted(
        (e for e in rows if e.device_type == cuda and not is_span(e.key)), key=self_dev,
        reverse=True,
    )
    ops = sorted((e for e in rows if e.device_type != cuda), key=self_dev, reverse=True)
    top = lambda evs: [
        {"name": e.key[:90], "calls": e.count, "ms": self_dev(e) / 1e3} for e in evs[:10]
    ]
    return {
        "phases": phases,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / wall_us,
        "top_kernels": top(kernels),
        "top_ops": top(ops),
    }


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("dygformer", "tgat"), default="dygformer")
    parser.add_argument("--mode", choices=("eval", "train"), default="eval")
    parser.add_argument("--batches", type=int, default=10)
    parser.add_argument("--configs", default="",
                        help="comma-separated configuration names (default: all of the model's)")
    parser.add_argument("--repo", default=REPO_ROOT,
                        help="tree whose dyglib_tpu_torch is run (default: this checkout)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_eval: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    from dyglib_tpu_torch.data import synthetic_link_prediction_data
    from dyglib_tpu_torch.models import TGAT, DyGFormer
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    def synced(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    print(json.dumps({"record_function_us": range_cost_us()}), flush=True)
    data = synthetic_link_prediction_data(num_src=8227, num_dst=1000, num_edges=157474, seed=1)
    n = data.train.num_interactions
    if args.model == "tgat":
        runs = [(name, TGAT(**kw), use_kernels, False) for name, kw, use_kernels in TGAT_CONFIGS]
    else:
        runs = [
            (config, DyGFormer(max_input_sequence_length=maxlen, patch_size=patch,
                               use_entry_fetch=args.mode == "train" and config == "CanParl"),
             True, args.mode == "train" and config == "CanParl")
            for config, maxlen, patch in CONFIGS
        ]
    wanted = set(filter(None, args.configs.split(",")))
    for config, backbone, use_kernels, fetch in runs:
        if wanted and config not in wanted:
            continue
        tr = LinkPredictionTrainer(backbone, data, TrainConfig(batch_size=B), device="cuda")
        tr.init_params(0)
        tr.model.use_kernels = use_kernels
        if args.mode == "eval":
            tr.evaluate(data.val.slice(0, B), tr.val_neg)  # warm-up
            run = synced(lambda: tr.evaluate(data.val.slice(0, args.batches * B), tr.val_neg))
        else:
            tr.train_epoch(data.train.slice(n - B, n))  # warm-up
            stream = data.train.slice(n - args.batches * B, n)
            run = synced(lambda: tr.train_epoch(stream))
        torch.cuda.synchronize()
        host_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            run()
            host_ms.append((time.perf_counter() - t0) * 1e3 / args.batches)
        out = {"config": config, "mode": args.mode, "batches": args.batches,
               "use_kernels": use_kernels, "entry_fetch": fetch,
               "repo": os.path.abspath(args.repo), "ms_per_batch": host_ms}
        out.update(device_profile(run))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
