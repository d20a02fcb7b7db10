#!/usr/bin/env python3
"""Time the patch projection's kernels on one card, against one PyTorch call.

    python3 scripts/time_patch_projection.py

At chip_smoke.py's shapes (M = 600 rows of the B = 200 triple, D = 172,
ced = 50; wikipedia: Lp 32, patch 1; CanParl: Lp 2048, patch 64), random
inputs from seed 1234, each kernel and its library call (``torch.addmm``
for the forward, ``torch.mm(x.t(), dout)`` for the backward's dW) in turns,
kernel, library, library, kernel, two ways:

  * eager: CUDA events around back-to-back calls, after a warm-up. Where a
    call's host work (the wrapper, the allocation, the launch) outlasts
    its device work, this measures the host;
  * device: the same calls captured in a CUDA graph and replayed, which
    leaves only the device time (and the gaps between graph nodes).

Then the forward once for each block size the wrapper may pick
(``ops/patch_projection.py`` TILE_MS), the K split chosen for it as the
wrapper does, device time, in turns. Prints the card's name and power
limit, then one JSON line. Needs a CUDA card.
"""
import importlib
import json
import os
import statistics
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, FEAT, CED = 600, 172, 50
CONFIGS = (("wikipedia", 32, 1), ("CanParl", 2048, 64))


def event_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, calls: int = 20) -> float:
    """Device ms per call: ``calls`` calls captured in one CUDA graph."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return event_ms(graph.replay, 5) / calls


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_patch_projection: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO_ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    from dyglib_tpu_torch import ops

    pp = importlib.import_module("dyglib_tpu_torch.ops.patch_projection")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(1234)
    results = {}
    for config, lp, patch in CONFIGS:
        rows, k = M * (lp // patch), patch * FEAT
        iters = 20 if lp > 100 else 200
        x = torch.randn((M, lp, FEAT), device=dev, generator=gen)
        x[:, lp // 2 :] = 0.0
        w = ((torch.rand((CED, k), device=dev, generator=gen) * 2 - 1) * k**-0.5).t()
        bias = (torch.rand(CED, device=dev, generator=gen) * 2 - 1) * k**-0.5
        dout = 1e-3 * torch.randn((M, lp // patch, CED), device=dev, generator=gen)
        x2, g2 = x.view(rows, k), dout.view(rows, CED)
        calls = {
            "fwd": lambda: ops.patch_projection(x, w, bias, patch),
            "addmm": lambda: torch.addmm(bias, x2, w),
            "bwd": lambda: ops.patch_projection_backward(x, dout, patch),
            "mm": lambda: torch.mm(x2.t(), g2),
        }
        entry = {name: {"eager_ms": [], "device_ms": []} for name in calls}
        for pair in (("fwd", "addmm"), ("bwd", "mm")):
            for name in (*pair, *pair[::-1]):
                entry[name]["eager_ms"].append(event_ms(calls[name], iters))
                entry[name]["device_ms"].append(graph_ms(calls[name]))
        plan = pp.forward_plan(rows, k, CED, torch.cuda.get_device_properties(dev)
                               .multi_processor_count)
        entry["forward_plan"] = {"tile_m": plan[0], "k_chunk": plan[1]}
        chosen = pp.forward_plan
        tiles = {}
        try:
            for tile_m in (*pp.TILE_MS, *pp.TILE_MS[::-1]):
                k_chunk = pp.TILE_K * pp.best_plan(
                    rows, CED, -(-k // pp.TILE_K), rows * CED,
                    torch.cuda.get_device_properties(dev).multi_processor_count, (tile_m,))[1]
                pp.forward_plan = lambda *a, t=tile_m, c=k_chunk: (t, c)
                tiles.setdefault(str(tile_m), []).append(graph_ms(calls["fwd"]))
        finally:
            pp.forward_plan = chosen
        entry["forward_device_ms_by_tile_m"] = tiles
        results[config] = entry
        for name in calls:
            print(f"{config:<10} {name:<6} eager {entry[name]['eager_ms']} ms  "
                  f"device {entry[name]['device_ms']} ms", flush=True)
        print(f"{config:<10} forward plan {plan}; device ms by block rows {tiles}", flush=True)
        del x, x2, w, dout, g2
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "patch_projection": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
