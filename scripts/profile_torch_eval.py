#!/usr/bin/env python3
"""Where the time of the PyTorch port's evaluation or training goes, on one card.

    python3 scripts/profile_torch_eval.py [--model dygformer|tgat|tgn|dyrep|jodie|
                                                   graphmixer|tcl|cawn]
                                          [--task link_prediction|node_classification]
                                          [--mode eval|train] [--batches 10]
                                          [--negatives random|historical|inductive]
                                          [--configs NAMES] [--scan] [--mesh]
                                          [--strategy recent|uniform|time_interval_aware]
                                          [--repo DIR]

Same setting as chip_smoke.py (synthetic wikipedia-scale stream, seed 1;
random weights, seed 0; B = 200). DyGFormer: the wikipedia (maxlen 32,
patch 1) and CanParl (maxlen 2048, patch 64) configurations, kernel path.
TGAT: the published widths (K = 20, 2 layers, 2 heads, Dt = 100), the
default kernel path (gathered attention at layer 1, fused attention at
layer 2; in training their backward kernels too), the plain path and the
Phi fusion (``use_phi_fusion=True``: the Phi projection's kernels, two a
convolution), each under ``--strategy`` (``recent`` by default;
``uniform`` and ``time_interval_aware`` draw from the trainer's
generators, and their ``train/sample`` and ``eval/sample`` ranges hold the
draws: time_interval_aware's bisection on ``csr.tia_cew``, at the
trainers' time scaling factor 1e-6). TGN, DyRep, JODIE: the published widths (TGN and DyRep K =
10, 1 layer, 2 heads; memory 172, Dt = 100; time shifts from the train
split), the kernel path (TGN's and DyRep's temporal attention kernel) and
the plain path, each sweep from an empty memory. GraphMixer, TCL and CAWN:
the published wikipedia widths (GraphMixer K = 30, 2 layers, time gap
2000, dropout 0.5; TCL K = 20, 2 layers, 2 heads; CAWN K = 32, walk length
1, 8 walk heads, position features 172, time_interval_aware; Dt = 100),
whose paths run no kernel of the port. ``--configs`` picks
configurations by name (comma-separated, e.g. "TGAT Phi fusion");
``--task node_classification`` runs the model's node-classification
path instead (``NodeClassificationTrainer`` on the same stream split by
the node-classification rule; the model at its published wikipedia
node-classification widths, ``load_node_classification_best_configs``,
built by ``build_backbone`` with seed-0 weights; the head seed 0 at the
published dropout; kernel path and plain path): ``--mode eval`` traces
``evaluate`` over the first val batches (a memory model's from an empty
memory), ``--mode train`` one ``train_epoch`` of head training over the
last train batches; its ranges are ``nodecls/sample``, ``nodecls/forward``,
``nodecls/commit`` (memory models), ``nodecls/head`` and in training
``nodecls/backward`` and ``nodecls/optimizer``. ``--scan`` runs the scan
path instead (``TrainConfig(scan_epochs=True)``, no sequence buckets:
``train_epoch_scanned`` and ``evaluate(scanned=True)``, every step after a
sweep's first a CUDA graph replay; the warm-up is one whole sweep, so the
graphs are captured before the timing and the trace): a replay opens no
profiler range, so its step ranges' device ms a batch come from the phase
marks each replay runs (``dyglib_tpu_torch/train/phases.py``: a range from
its mark's start to the next mark's start, the last to the step's end
mark), under the loop's range names, and the sweep's own spans
(``<p>/negatives``, ``<p>/staging``, ``<p>/replays``, ``<p>/read_back``,
``<p>/scoring``) give their host and device ms a sweep. ``--mesh`` runs the
link-prediction trainers on the (1, 1) mesh of a one-rank NCCL process
group (``dyglib_tpu_torch.parallel``): each collective is its own range,
``mesh/<call site>``, inside the loop's ranges. ``--repo`` names the tree whose
``dyglib_tpu_torch`` is run (default: this checkout), so that two trees
run by one command in turns compare on one card. For each configuration
it first times the same sweep twice with no profiler (host clock, ending
in a synchronize: ``ms_per_batch``), then traces, with torch.profiler, one
``evaluate`` sweep over the first val batches (``--mode eval``; val
negatives of the ``--negatives`` strategy, random by default: historical
and inductive ones are drawn in ``eval/staging`` and embedded as the
quad) or one ``train_epoch`` over the last train batches (``--mode
train``, dropout 0.1; wikipedia on the gather path, CanParl with the entry
fetch, as chip_smoke.py drives them), and reports:

  * per batch, the host time and the device time of each of the loop's
    own profiler ranges. evaluate: ``eval/staging`` (negative draw, bucket
    pick, host-to-device copies), ``eval/sample`` (``DyGFormer.sample``),
    ``eval/forward`` (the network), ``eval/head`` (head + loss) and
    ``eval/metrics`` (copy-back, which waits for the device, + metrics);
    for TGAT ``eval/sample`` is ``TGAT.sample`` (the multi-hop fan-out).
    train_step: ``train/sample``, ``train/forward`` (network, with the
    entry fetch where it runs, head and loss), ``train/backward``,
    ``train/commit`` (a memory model's state transition) and
    ``train/optimizer`` (Adam); a memory model's eval batch adds
    ``eval/commit``.
    A range's device time is that of the kernels launched, from any host
    thread, while the range was open: autograd launches the backward's
    kernels from its own thread, outside the range's child ops;
  * the device busy share of the window (the union of device kernel
    intervals over the wall time), and the ten device kernels and the ten
    PyTorch ops with the most self device time. The profiler also draws
    each range (and the optimizer's step range) on the device timeline;
    those spans are not device work and are left out of both.

First it prints the host cost of one profiler range with no profiler
running (evaluate opens five per batch, train_step four; a memory model one
more each), then one JSON line per configuration. Needs a CUDA card;
raises if the profiler records no device time.
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
MEMORY_MODELS = {"tgn": "TGN", "dyrep": "DyRep", "jodie": "JODIE"}
# the models with no kernel on their paths, at their published widths
KERNEL_FREE = {
    "graphmixer": ("GraphMixer", dict(num_neighbors=30, num_layers=2, dropout=0.5,
                                      time_gap=2000)),
    "tcl": ("TCL", dict(num_neighbors=20, num_layers=2, num_heads=2, dropout=0.1)),
    "cawn": ("CAWN", dict(num_neighbors=32, walk_length=1, num_walk_heads=8,
                          position_feat_dim=172, dropout=0.1)),
}


def is_range(name: str) -> bool:
    """One of the loops' own profiler ranges, or a collective's (``mesh/``)."""
    return name.startswith(("eval/", "train/", "nodecls/", "mesh/"))


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


def mark_device_ms(prof) -> dict[str, float]:
    """Device ms a replayed step in each of the loop's ranges that has a
    phase mark: from the range's mark to the next mark of its replay."""
    from torch.autograd import DeviceType

    from dyglib_tpu_torch.train import phases

    ranges = {phases.kernel_name(m): m for m in phases.MARKS}
    marks = sorted((e.start_ns(), ranges[e.name()]) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA and e.name() in ranges)
    total, count = {}, {}
    for (t, name), (t_next, _) in zip(marks, marks[1:]):
        if name != phases.STEP_END:
            total[name] = total.get(name, 0.0) + (t_next - t) / 1e6
            count[name] = count.get(name, 0) + 1
    return {name: total[name] / count[name] for name in total}


def device_profile(run, scanned: bool = False) -> dict:
    """Trace ``run()`` (which ends in a synchronize); ``scanned``: graph
    replays, whose ranges come from their phase marks."""
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
    if not scanned and not phases:
        raise RuntimeError("the trace holds none of the loop's eval/*, train/* or nodecls/* "
                           "ranges")
    if not scanned and not any(device_ms.values()):
        raise RuntimeError("no device time could be tied to a range's launches")
    if scanned:  # the ranges that open once a sweep, and the replays' marks
        marked = mark_device_ms(prof)
        if not marked:
            raise RuntimeError("the trace holds no phase mark of a replay")
        phases = {**{k: {"host_ms_per_sweep": v["host_ms_per_batch"],
                         "device_ms_per_sweep": v["device_ms_per_batch"]}
                     for k, v in phases.items()},
                  **{k: {"device_ms_per_batch": ms} for k, ms in marked.items()}}
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


def profile_node_classification(args, data, synced) -> int:
    """``--task node_classification``: the model's kernel and plain paths."""
    import torch

    from dyglib_tpu_torch.configs import build_backbone, get_node_classification_args
    from dyglib_tpu_torch.data import split_node_classification_data
    from dyglib_tpu_torch.train import NodeClassificationTrainer, TrainConfig

    name = {"dygformer": "DyGFormer", "tgat": "TGAT", **MEMORY_MODELS,
            **{k: v[0] for k, v in KERNEL_FREE.items()}}[args.model]
    nc = split_node_classification_data(data.full, data.edge_raw_features,
                                        data.node_raw_features)
    cli = get_node_classification_args(["--model_name", name, "--dataset_name", "wikipedia",
                                        "--load_best_configs"])
    if name == "TGAT":
        cli.sample_neighbor_strategy = args.strategy
    backbone = build_backbone(cli, data)
    params = backbone.build(nc.node_raw_features.shape[1], nc.edge_raw_features.shape[1],
                            torch.Generator().manual_seed(0)).state_dict()
    n = nc.train.num_interactions
    wanted = set(filter(None, args.configs.split(",")))
    for path in ("kernels", "plain"):
        config = f"{name} node-class {path}"
        if wanted and config not in wanted:
            continue
        tr = NodeClassificationTrainer(
            backbone, nc, TrainConfig(batch_size=B, head_dropout=cli.dropout,
                                      scan_epochs=args.scan), None, params, device="cuda")
        tr.init_params(0)
        tr.model.use_kernels = path == "kernels"
        if args.mode == "eval":
            tr.evaluate(nc.val.slice(0, B))  # warm-up
            run = synced(lambda: tr.evaluate(nc.val.slice(0, args.batches * B)))
        else:
            tr.train_epoch(nc.train.slice(n - B, n))  # warm-up
            stream = nc.train.slice(n - args.batches * B, n)
            train = tr.train_epoch_scanned if args.scan else tr.train_epoch
            run = synced(lambda: train(stream))
        if args.scan:
            run()  # captures the graphs
        torch.cuda.synchronize()
        host_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            run()
            host_ms.append((time.perf_counter() - t0) * 1e3 / args.batches)
        out = {"config": config, "task": args.task, "mode": args.mode,
               "batches": args.batches, "use_kernels": path == "kernels", "scan": args.scan,
               "strategy": backbone.sample_strategy,
               "repo": os.path.abspath(args.repo), "ms_per_batch": host_ms}
        out.update(device_profile(run, args.scan))
        print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("dygformer", "tgat", *MEMORY_MODELS, *KERNEL_FREE),
                        default="dygformer")
    parser.add_argument("--task", choices=("link_prediction", "node_classification"),
                        default="link_prediction")
    parser.add_argument("--mode", choices=("eval", "train"), default="eval")
    parser.add_argument("--batches", type=int, default=10)
    parser.add_argument("--negatives", choices=("random", "historical", "inductive"),
                        default="random", help="the val negatives' strategy (--mode eval)")
    parser.add_argument("--configs", default="",
                        help="comma-separated configuration names (default: all of the model's)")
    parser.add_argument("--scan", action="store_true",
                        help="the scan path: sweeps replayed as CUDA graphs")
    parser.add_argument("--repo", default=REPO_ROOT,
                        help="tree whose dyglib_tpu_torch is run (default: this checkout)")
    parser.add_argument("--mesh", action="store_true",
                        help="run the trainers on the (1, 1) mesh of a one-rank NCCL group")
    parser.add_argument("--strategy", choices=("recent", "uniform", "time_interval_aware"),
                        default="recent", help="TGAT's neighbor sample strategy")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_eval: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    from dyglib_tpu_torch.data import synthetic_link_prediction_data
    from dyglib_tpu_torch.graph import build_eval_neg_samplers
    from dyglib_tpu_torch import models
    from dyglib_tpu_torch.models import (
        TGAT,
        DyGFormer,
        MemoryModel,
        compute_src_dst_node_time_shifts,
    )
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    def synced(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    print(json.dumps({"record_function_us": range_cost_us()}), flush=True)
    data = synthetic_link_prediction_data(num_src=8227, num_dst=1000, num_edges=157474, seed=1)
    n = data.train.num_interactions
    if args.task == "node_classification":
        return profile_node_classification(args, data, synced)
    if args.model == "tgat":
        runs = [(name, TGAT(sample_strategy=args.strategy, **kw), use_kernels, False)
                for name, kw, use_kernels in TGAT_CONFIGS]
    elif args.model in MEMORY_MODELS:
        name = MEMORY_MODELS[args.model]
        shifts = compute_src_dst_node_time_shifts(data.train.src, data.train.dst, data.train.ts)
        runs = [(f"{name} {path}", MemoryModel(model_name=name, time_shifts=shifts),
                 path == "kernels", False) for path in ("kernels", "plain")]
    elif args.model in KERNEL_FREE:
        name, kw = KERNEL_FREE[args.model]
        runs = [(name, getattr(models, name)(**kw), False, False)]
    else:
        runs = [
            (config, DyGFormer(max_input_sequence_length=maxlen, patch_size=patch,
                               use_entry_fetch=args.mode == "train" and config == "CanParl"),
             True, args.mode == "train" and config == "CanParl")
            for config, maxlen, patch in CONFIGS
        ]
    mesh = None
    if args.mesh:
        from dyglib_tpu_torch.parallel import free_port, initialize_distributed, make_mesh

        initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
        mesh = make_mesh(1, 1)
    wanted = set(filter(None, args.configs.split(",")))
    for config, backbone, use_kernels, fetch in runs:
        if wanted and config not in wanted:
            continue
        tr = LinkPredictionTrainer(backbone, data, TrainConfig(
            batch_size=B, scan_epochs=args.scan, sequence_buckets=not args.scan), device="cuda",
            mesh=mesh)
        tr.init_params(0)
        tr.model.use_kernels = use_kernels
        if args.mode == "eval":
            negs = build_eval_neg_samplers(data, args.negatives)[0]
            tr.evaluate(data.val.slice(0, B), negs)  # warm-up
            run = synced(lambda: tr.evaluate(data.val.slice(0, args.batches * B), negs))
        else:
            tr.train_epoch(data.train.slice(n - B, n))  # warm-up
            stream = data.train.slice(n - args.batches * B, n)
            train = tr.train_epoch_scanned if args.scan else tr.train_epoch
            run = synced(lambda: train(stream))
        if args.scan:
            run()  # captures the graphs
        torch.cuda.synchronize()
        host_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            run()
            host_ms.append((time.perf_counter() - t0) * 1e3 / args.batches)
        out = {"config": config, "mode": args.mode, "batches": args.batches,
               "negatives": args.negatives,
               "strategy": getattr(backbone, "sample_strategy", None),
               "use_kernels": use_kernels, "entry_fetch": fetch, "scan": args.scan,
               "mesh": args.mesh,
               "repo": os.path.abspath(args.repo), "ms_per_batch": host_ms}
        out.update(device_profile(run, args.scan))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
