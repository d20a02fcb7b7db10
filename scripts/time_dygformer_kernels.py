#!/usr/bin/env python3
"""Time DyGFormer's time-channel forward and backward, co-occurrence and
window-fetch kernels on one card, by CUDA-graph replay (device time).

    python3 scripts/time_dygformer_kernels.py [--repo DIR] [--rounds N]

``--repo`` names the tree whose ``dyglib_tpu_torch`` is imported (default:
this checkout). Two trees timed by one command in turns, parent, change,
change, parent, compare two versions of the kernels on one card.

At chip_smoke.py's shapes (M = 600 rows of the B = 200 triple, Dt = 100,
ced = 50; wikipedia: L 32, patch 1; CanParl: L 2048, patch 64), inputs from
a seeded generator, identical in every tree:

  * time_channel: ``time_channel_projection`` forward; its library
    yardstick (Phi by ``torch.where(cos(...))``, then ``torch.addmm``, as in
    chip_smoke.py); and the kernel again with tw scaled by 0.05, so that
    |theta| < 1e5 (dt < 1e6, tw <= 1): no cosine takes cosf's slow
    argument reduction. The difference between the two is what the slow
    path costs. And the kernel with every position masked (no cosine
    taken where the kernel skips masked positions): the product alone.
  * time_channel_bwd: ``time_channel_backward`` (dout ~ 1e-3 N(0, 1)); its
    partial library yardstick, the two products alone on a precomputed
    Phi, ``torch.mm(Phi^T, dout)`` and ``torch.mm(dout, W^T)`` (no sines,
    no sums over rows of dtw and dtb, Phi's cosines not timed); and the
    kernel with every position masked (the dbias product alone).
  * cooccurrence: the self launch (600 rows, q = k) and the cross launch
    (800 rows), half of each row pads (id 0).
  * window_fetch: ``fetch_sequence_features`` against ``index_select`` of
    the same rows.

And the co-occurrence count's two paths against each other (where the
tree has them): both launches of a batch (600 self rows, 800 cross rows,
half of each row pads) at row lengths CO_LENGTHS, forced onto the
all-pairs path and onto the hash table in turns; the crossover sets
``ops/cooccurrence.py::ALL_PAIRS_MAX_LK``.

Each measurement is taken ``--rounds`` times, in turns with the others.
Prints the card's name and power limit, then one JSON line. Needs a CUDA
card.
"""
import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, CED, DT_DIM, FEAT = 200, 50, 100, 172
CONFIGS = (("wikipedia", 32, 1), ("CanParl", 2048, 64))
CO_LENGTHS = (32, 64, 96, 128, 192, 256, 512)


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


def calls_for(config, lp, patch, dev, ops, spectrum):
    """{name: zero-argument call} at one configuration's shapes."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1234)
    m = 3 * B
    rows, k = m * (lp // patch), patch * DT_DIM
    dt = torch.randint(0, 1_000_000, (m, lp), device=dev, generator=gen).float()
    valid = torch.rand((m, lp), device=dev, generator=gen) < 0.8
    tw = torch.from_numpy(spectrum(DT_DIM)).reshape(-1).to(dev)
    tb = 0.1 * torch.randn(DT_DIM, device=dev, generator=gen)
    w = ((torch.rand((CED, k), device=dev, generator=gen) * 2 - 1) * k**-0.5).t()
    bias = (torch.rand(CED, device=dev, generator=gen) * 2 - 1) * k**-0.5
    small_tw = tw * 0.05
    none_valid = torch.zeros_like(valid)

    def library_time_channel():
        phi = torch.where(valid[..., None], torch.cos(dt[..., None] * tw + tb), 0.0)
        return torch.addmm(bias, phi.view(rows, k), w)

    ids = torch.randint(1, 400, (4 * B, lp), device=dev, generator=gen, dtype=torch.int32)
    ids[:, lp // 2 :] = 0
    partner = torch.cat([ids[2 * B :], ids[: 2 * B]]).contiguous()
    q_self = ids[: 3 * B].contiguous()

    pad, entries, nodes = max(512, lp), 2 * 157474, 9229
    table = torch.randn((2 * pad + entries + nodes + 16, 2 * FEAT), device=dev, generator=gen)
    table[:pad] = 0.0
    table[pad + entries : 2 * pad + entries] = 0.0
    counts = torch.randint(0, lp, (m,), device=dev, generator=gen, dtype=torch.int32)
    starts = pad + torch.randint(0, entries - lp, (m,), device=dev, generator=gen,
                                 dtype=torch.int32)
    tgts = 2 * pad + entries + torch.randint(0, nodes, (m,), device=dev, generator=gen,
                                             dtype=torch.int32)
    from dyglib_tpu_torch.ops.window_fetch import window_rows

    idx = window_rows(tgts, starts, counts, lp).view(-1)
    # drawn last, so that every earlier input is what it was before
    dout = 1e-3 * torch.randn((m, lp // patch, CED), device=dev, generator=gen)
    phi = torch.where(valid[..., None], torch.cos(dt[..., None] * tw + tb), 0.0).view(rows, k)
    g2 = dout.view(rows, CED)
    return {
        "time_channel": lambda: ops.time_channel_projection(dt, valid, tw, tb, w, bias, patch),
        "time_channel_library": library_time_channel,
        "time_channel_small_theta": lambda: ops.time_channel_projection(
            dt, valid, small_tw, tb, w, bias, patch),
        "time_channel_none_valid": lambda: ops.time_channel_projection(
            dt, none_valid, tw, tb, w, bias, patch),
        "time_channel_bwd": lambda: ops.time_channel_backward(dt, valid, tw, tb, w, dout, patch),
        "time_channel_bwd_library_partial": lambda: (torch.mm(phi.t(), g2), torch.mm(g2, w.t())),
        "time_channel_bwd_none_valid": lambda: ops.time_channel_backward(
            dt, none_valid, tw, tb, w, dout, patch),
        "cooccurrence_self": lambda: ops.cooccurrence_counts(q_self, q_self),
        "cooccurrence_cross": lambda: ops.cooccurrence_counts(ids, partner),
        "window_fetch": lambda: ops.fetch_sequence_features(table, tgts, starts, counts, lp,
                                                            FEAT),
        "window_fetch_index_select": lambda: table.index_select(0, idx),
    }


def cooccurrence_paths(dev, ops, co, rounds: int) -> dict:
    """{row length: {"pairs": [ms], "table": [ms]}}: device ms of a batch's
    two co-occurrence launches on each path."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(99)
    switch, results = co.ALL_PAIRS_MAX_LK, {}
    try:
        for lp in CO_LENGTHS:
            ids = torch.randint(1, 400, (4 * B, lp), device=dev, generator=gen, dtype=torch.int32)
            ids[:, lp // 2 :] = 0
            partner = torch.cat([ids[2 * B :], ids[: 2 * B]]).contiguous()
            q_self = ids[: 3 * B].contiguous()

            def both():
                ops.cooccurrence_counts(q_self, q_self)
                ops.cooccurrence_counts(ids, partner)

            entry = {"pairs": [], "table": []}
            for r in range(rounds):
                for path in ("pairs", "table") if r % 2 == 0 else ("table", "pairs"):
                    co.ALL_PAIRS_MAX_LK = 2**30 if path == "pairs" else 0
                    entry[path].append(graph_ms(both))
            results[str(lp)] = entry
            print(f"cooccurrence L {lp:<5} pairs {['%.5f' % t for t in entry['pairs']]} ms  "
                  f"table {['%.5f' % t for t in entry['table']]} ms", flush=True)
    finally:
        co.ALL_PAIRS_MAX_LK = switch
    return results


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=REPO_ROOT,
                        help="tree whose dyglib_tpu_torch is timed (default: this checkout)")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_dygformer_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.nn.modules import time_encoder_spectrum
    from dyglib_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"timing {os.path.abspath(ops.__file__)}", flush=True)
    _build.build(["time_channel", "cooccurrence", "window_fetch"])
    dev = torch.device("cuda:0")
    results = {}
    for config, lp, patch in CONFIGS:
        calls = calls_for(config, lp, patch, dev, ops, time_encoder_spectrum)
        entry = {name: [] for name in calls}
        order = list(calls)
        for r in range(args.rounds):
            for name in order if r % 2 == 0 else order[::-1]:
                entry[name].append(graph_ms(calls[name]))
        results[config] = entry
        for name, times in entry.items():
            print(f"{config:<10} {name:<34} device {['%.5f' % t for t in times]} ms", flush=True)
        del calls
        torch.cuda.empty_cache()
    co = importlib.import_module("dyglib_tpu_torch.ops.cooccurrence")
    if hasattr(co, "ALL_PAIRS_MAX_LK"):
        results["cooccurrence_paths"] = cooccurrence_paths(dev, ops, co, args.rounds)
    print(json.dumps({"card": card, "repo": os.path.abspath(args.repo), "device_ms": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
