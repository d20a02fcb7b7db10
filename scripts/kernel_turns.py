#!/usr/bin/env python3
"""Two checkouts' DyGFormer kernels on one card: the f32 outputs bit for
bit, the bf16 forwards' times.

    python3 scripts/kernel_turns.py --repo DIR --out FILE.pt [--compare OTHER.pt]
                                    [--sweep] [--only NAME,...]
    python3 scripts/kernel_turns.py --repo DIR --interleave OTHER_DIR [--rounds N]

Builds the port's kernels from ``DIR`` (its own ``dyglib_tpu_torch/build``)
and runs, on inputs drawn from seed 2468 at the shapes of chip_smoke.py
(DyGFormer wikipedia: 600 rows of 32 positions, patch 1; CanParl: 600 rows
of 2048, patch 64; Dt 100, D 172, ced 50):
  * the split-TF32 kernels #1 and #1b (the time channel), #3 and #3b (the
    patch projection) at both shapes and #8b (the Phi projection's
    backward, 240,000 rows, dq 272): every output saved to ``FILE.pt``
    with the kernel's ms;
  * the bf16 forwards #1' and #3' and the bf16 time-channel backward #1b'
    at both shapes: ms, each held to its plain bf16 version (the largest
    difference as a share of sum|terms|, per gradient for #1b', and for
    #3' the outputs past that share: one-ulp rounding flips) and a second
    launch bitwise equal; which launch counters moved.
Times are CUDA-event medians of 5 repeats of back-to-back calls (the bf16
kernels' ``device_ms`` also by the replay of a CUDA graph of those calls,
without the host's work between them). With
``--compare`` it prints, per f32 output, whether it equals OTHER's bit for
bit, and both trees' times of every kernel; it exits 1 if an f32 output
differs or a bf16 check fails. Run it for two checkouts in one call, in
turns (parent, change, change, parent), to compare their times on one
card. ``--sweep`` also times the wgmma forwards at CanParl at each K split
of ``SWEEP_SPLITS``, and the wgmma backward at CanParl at each entry
layout of ``SWEEP_PADS`` and row chunk count of ``SWEEP_CHUNKS`` (the tree
must have them); ``--only`` keeps the named
entries (e.g. ``bf16_time_channel@CanParl``), ``--libs`` builds only the
named libraries, ``--build-log`` keeps nvcc's output (ptxas's register
and spill report of every kernel).

``--interleave OTHER_DIR`` times #1' and #1b' at the wikipedia shape only,
the wrapper of ``DIR``'s package and of OTHER_DIR's (imported under a
second name, each with its own build) in one process, ``--rounds`` rounds,
the order swapped each round: the wrapper's CUDA-event ms (host-bound
there) and the device ms of a CUDA graph of its calls, per round, then
how many rounds DIR's was the faster and both medians. One process spares the
pairs the variance between processes (core placement, clocks).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

GRAD_RTOL = 3e-5  # chip_smoke.py's share of sum|terms|
SWEEP_SPLITS = (1, 2, 3, 4, 5, 6, 7, 8, 11, 14)
SWEEP_PADS = (100, 104, 112)  # the backward's entry layouts at Dt 100
SWEEP_CHUNKS = (2, 3, 4, 5, 6, 8, 10, 13, 20)
CONFIGS = (("wikipedia", 32, 1), ("CanParl", 2048, 64))


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()


def cuda_ms(fn, iters: int, reps: int = 5) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, iters: int) -> float:
    """Device ms a call: ``iters`` calls captured in one CUDA graph, its
    replays timed by cuda_ms (no host work between the launches)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, 1) / iters


def bf16_ulp(v):
    import torch

    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), torch.frexp(v.float()).exponent - 8)


def run(only, sweep: bool) -> tuple[dict, dict]:
    """(f32 name -> (outputs, ms), bf16 name -> measurements)."""
    import importlib

    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.nn.modules import time_encoder_spectrum

    dev = torch.device("cuda:0")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2468)
    dt_dim, feat, ced, m = 100, 172, 50, 600
    tw = torch.from_numpy(time_encoder_spectrum(dt_dim)).reshape(-1).to(dev)
    tb = 0.1 * torch.randn(dt_dim, device=dev, generator=gen)
    f32, b16 = {}, {}
    want = lambda name: not only or name in only

    def check_bf16(name, fn, plain, terms, rounded):
        out, again, ref = fn(), fn(), plain()
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        rel = float((diff / terms.clamp_min(1e-30)).max())
        entry = dict(max_abs_err=float(diff.max()), rel=rel, repeat_equal=torch.equal(out, again))
        if rounded:  # the twice-rounded bf16 output: flips past GRAD_RTOL, each within 2 ulp
            prod_ulp, out_ulp = bf16_ulp(terms), bf16_ulp(ref)
            entry["flips"] = int((diff > GRAD_RTOL * terms).sum())
            entry["ok"] = bool((diff <= GRAD_RTOL * terms + prod_ulp + out_ulp).all()) and (
                entry["flips"] <= max(1, out.numel() // 1000))
        else:
            entry["ok"] = rel <= GRAD_RTOL
        entry["ok"] = entry["ok"] and entry["repeat_equal"]
        return entry

    def check_bwd(dt, valid, tw, tb, w, dout, patch, iters):
        """#1b' held to the plain bf16 backward: each gradient's largest
        difference as a share of its sum|terms| (the terms in bf16
        operands), a second launch bitwise equal; ms, launches, device ms,
        the device kernels of one call."""
        args = (dt, valid, tw, tb, w, dout, patch)
        fn = lambda: ops.time_channel_backward(*args, compute_dtype=bf16)
        got, again = fn(), fn()
        want = ops.time_channel_backward_plain(*args, compute_dtype=bf16)
        rows, k = dout.shape[0] * dout.shape[1], w.shape[0]
        theta = dt[..., None] * tw + tb
        g16 = dout.reshape(rows, -1).to(bf16).float().abs()
        phi16 = torch.where(valid[..., None], torch.cos(theta), 0.0).to(bf16).float()
        common = torch.where(valid[..., None], (g16 @ w.to(bf16).float().abs().t()).reshape(
            theta.shape) * torch.sin(theta).abs(), 0.0)
        terms = ((common * dt[..., None].abs()).sum((0, 1)), common.sum((0, 1)),
                 phi16.abs().reshape(rows, k).t() @ g16, dout.reshape(rows, -1).abs().sum(0))
        torch.cuda.synchronize()
        rel = [float(((a - b).abs() / t.clamp_min(1e-30)).max()) for a, b, t in
               zip(got, want, terms)]
        entry = dict(max_abs_err=max(float((a - b).abs().max()) for a, b in zip(got, want)),
                     rel=max(rel), rel_each=rel,
                     repeat_equal=all(torch.equal(a, b) for a, b in zip(got, again)))
        entry["ok"] = entry["rel"] <= GRAD_RTOL and entry["repeat_equal"]
        del got, again, want, theta, g16, phi16, common, terms
        entry.update(ms=cuda_ms(fn, iters // 2), launches=counted(fn),
                     device_ms=graph_ms(fn, iters // 2), device_kernels=device_kernels(fn))
        return entry

    def device_kernels(fn):
        """The device kernels one call launches, by name (a torch.profiler
        trace of one call after a warm one)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name[:60] for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    def counted(fn):
        ops.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return {k: v for k, v in ops.launch_counts().items() if v}

    for config, lp, patch in CONFIGS:
        iters = 20 if lp > 100 else 200
        rows = m * (lp // patch)
        # ---- the time channel
        dt = torch.randint(0, 1_000_000, (m, lp), device=dev, generator=gen).float()
        valid = torch.rand((m, lp), device=dev, generator=gen) < 0.8
        k = patch * dt_dim
        w = ((torch.rand((ced, k), device=dev, generator=gen) * 2 - 1) * k**-0.5).t()
        bias = (torch.rand(ced, device=dev, generator=gen) * 2 - 1) * k**-0.5
        dout = 1e-3 * torch.randn((m, lp // patch, ced), device=dev, generator=gen)
        args = (dt, valid, tw, tb, w, bias, patch)
        fwd = lambda: ops.time_channel_projection(*args)
        bwd = lambda: ops.time_channel_backward(dt, valid, tw, tb, w, dout, patch)
        if want(f"time_channel@{config}"):
            f32[f"time_channel@{config}"] = ([fwd()], cuda_ms(fwd, iters))
        if want(f"time_channel_bwd@{config}"):
            f32[f"time_channel_bwd@{config}"] = (list(bwd()), cuda_ms(bwd, iters // 2))
        name = f"bf16_time_channel@{config}"
        if want(name):
            fn = lambda: ops.time_channel_projection(*args, compute_dtype=bf16)
            phi16 = torch.where(valid[..., None], torch.cos(dt[..., None] * tw + tb),
                                0.0).to(bf16).view(rows, k)
            terms = (phi16.float().abs() @ w.to(bf16).float().abs() + bias.abs()).view(
                m, lp // patch, ced)
            entry = check_bf16(name, fn,
                               lambda: ops.time_channel_projection_plain(*args, compute_dtype=bf16),
                               terms, rounded=False)
            entry.update(ms=cuda_ms(fn, iters), launches=counted(fn), device_ms=graph_ms(fn, iters))
            b16[name] = entry
            del phi16, terms
            if sweep and config == "CanParl":
                tc = importlib.import_module("dyglib_tpu_torch.ops.time_channel")
                kp = patch * tc.padded_dt(dt_dim, tc.BF16_DT_STEP)
                strides = (w.stride(0), w.stride(1))
                plan = tc.wgmma_forward_plan(rows, patch, dt_dim, ced, 132)
                entry["plan_splits"] = -(-kp // plan)
                entry["sweep"] = {}
                for s in SWEEP_SPLITS:
                    chunk = -(-(-(-kp // s)) // 64) * 64
                    if -(-kp // chunk) != s:
                        continue
                    go = lambda: tc._forward_bf16(dt, valid, tw, tb, w, bias, patch, strides,
                                                  k_chunk=chunk)
                    entry["sweep"][s] = cuda_ms(go, iters)
        name = f"bf16_time_channel_bwd@{config}"
        if want(name):
            b16[name] = check_bwd(dt, valid, tw, tb, w, dout, patch, iters)
            if sweep and config == "CanParl":
                tc = importlib.import_module("dyglib_tpu_torch.ops.time_channel")
                strides = (w.stride(0), w.stride(1))
                go = lambda **kw: lambda: tc._backward_bf16(dt, valid, tw, tb, w, dout, patch,
                                                            strides, **kw)
                b16[name]["sweep_pads"] = {p: cuda_ms(go(dt_pad=p), iters // 2)
                                           for p in SWEEP_PADS}
                b16[name]["plan_chunks"] = -(-rows // tc.wgmma_backward_plan(rows, patch, dt_dim,
                                                                             ced, 132))
                b16[name]["sweep_chunks"] = {
                    c: cuda_ms(go(chunk_rows=-(-(-(-rows // c)) // 64) * 64), iters // 2)
                    for c in SWEEP_CHUNKS}
        del dt, valid, w, bias, dout, args
        torch.cuda.empty_cache()

        # ---- the patch projection
        x = torch.randn((m, lp, feat), device=dev, generator=gen)
        x[:, lp // 2 :, :] = 0.0
        k = patch * feat
        w = ((torch.rand((ced, k), device=dev, generator=gen) * 2 - 1) * k**-0.5).t()
        bias = (torch.rand(ced, device=dev, generator=gen) * 2 - 1) * k**-0.5
        dout = 1e-3 * torch.randn((m, lp // patch, ced), device=dev, generator=gen)
        fwd = lambda: ops.patch_projection(x, w, bias, patch)
        bwd = lambda: ops.patch_projection_backward(x, dout, patch)
        if want(f"patch_projection@{config}"):
            f32[f"patch_projection@{config}"] = ([fwd()], cuda_ms(fwd, iters))
        if want(f"patch_projection_bwd@{config}"):
            f32[f"patch_projection_bwd@{config}"] = (list(bwd()), cuda_ms(bwd, iters))
        name = f"bf16_patch_projection@{config}"
        if want(name):
            x16 = x.to(bf16)
            fn = lambda: ops.patch_projection(x16, w, bias, patch, compute_dtype=bf16)
            terms = (x16.float().view(rows, k).abs() @ w.to(bf16).float().abs()
                     + bias.abs()).view(m, lp // patch, ced)
            entry = check_bf16(name, fn, lambda: ops.patch_projection_plain(
                x16, w, bias, patch, bf16, round_output=True), terms, rounded=True)
            x2, w16, b16v = x16.view(rows, k), w.to(bf16), bias.to(bf16)
            entry.update(ms=cuda_ms(fn, iters), launches=counted(fn), device_ms=graph_ms(fn, iters),
                         addmm_ms=cuda_ms(lambda: torch.addmm(b16v, x2, w16), iters))
            b16[name] = entry
            del terms
            if sweep and config == "CanParl":
                pp = importlib.import_module("dyglib_tpu_torch.ops.patch_projection")
                plan = pp.wgmma_forward_plan(rows, k, ced, 132)
                entry["plan_splits"] = -(-k // plan)
                entry["sweep"] = {}
                for s in SWEEP_SPLITS:
                    chunk = -(-(-(-k // s)) // 64) * 64
                    if -(-k // chunk) != s:
                        continue
                    go = lambda: pp._forward_wgmma(x16, w, bias, patch, k_chunk=chunk)
                    entry["sweep"][s] = cuda_ms(go, iters)
            del x16, x2
        del x, w, bias, dout
        torch.cuda.empty_cache()

    if want("phi_projection_bwd@tgat"):
        rows, dq = 240_000, 272
        dt = torch.rand(rows, device=dev, generator=gen) * 1e5
        w = (torch.rand((dt_dim, dq), device=dev, generator=gen) * 2 - 1) * dt_dim**-0.5
        dout = 1e-3 * torch.randn((rows, dq), device=dev, generator=gen)
        bwd = lambda: ops.phi_projection_backward(dt, tw, tb, w, dout)
        f32["phi_projection_bwd@tgat"] = (list(bwd()), cuda_ms(bwd, 50))
    torch.cuda.synchronize()
    return {k: ([t.cpu() for t in ts], ms) for k, (ts, ms) in f32.items()}, b16


def load_package(repo: str, name: str):
    """``repo``'s dyglib_tpu_torch imported as the package ``name``."""
    import importlib.util
    import os

    root = os.path.join(repo, "dyglib_tpu_torch")
    spec = importlib.util.spec_from_file_location(name, os.path.join(root, "__init__.py"),
                                                  submodule_search_locations=[root])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def interleave(other: str, rounds: int) -> dict:
    """#1' and #1b' at wikipedia: this tree's wrappers and ``other``'s in
    turns."""
    import importlib

    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.nn.modules import time_encoder_spectrum

    load_package(other, "other_tree")
    other_build = importlib.import_module("other_tree.ops._build")
    other_ops = importlib.import_module("other_tree.ops")
    other_build.build(["time_channel"])
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(2468)
    dt_dim, ced, m, lp, patch = 100, 50, 600, 32, 1
    tw = torch.from_numpy(time_encoder_spectrum(dt_dim)).reshape(-1).to(dev)
    tb = 0.1 * torch.randn(dt_dim, device=dev, generator=gen)
    dt = torch.randint(0, 1_000_000, (m, lp), device=dev, generator=gen).float()
    valid = torch.rand((m, lp), device=dev, generator=gen) < 0.8
    k = patch * dt_dim
    w = ((torch.rand((ced, k), device=dev, generator=gen) * 2 - 1) * k**-0.5).t()
    bias = (torch.rand(ced, device=dev, generator=gen) * 2 - 1) * k**-0.5
    args = (dt, valid, tw, tb, w, bias, patch)
    dout = 1e-3 * torch.randn((m, lp // patch, ced), device=dev, generator=gen)
    bargs = (dt, valid, tw, tb, w, dout, patch)
    bf16 = torch.bfloat16
    fns = {(kernel, tree): fn for tree, o in (("here", ops), ("other", other_ops))
           for kernel, fn in (
               ("forward", lambda o=o: o.time_channel_projection(*args, compute_dtype=bf16)),
               ("backward", lambda o=o: o.time_channel_backward(*bargs, compute_dtype=bf16)))}
    per_round = []
    for r in range(rounds):
        order = ("here", "other") if r % 2 == 0 else ("other", "here")
        per_round.append({f"{kernel} {tree}": {"ms": cuda_ms(fns[kernel, tree], 200),
                                               "device_ms": graph_ms(fns[kernel, tree], 200)}
                          for kernel in ("forward", "backward") for tree in order})
        print(f"round {r} {json.dumps(per_round[-1])}", flush=True)
    summary = {}
    for kernel in ("forward", "backward"):
        for key in ("ms", "device_ms"):
            here = [p[f"{kernel} here"][key] for p in per_round]
            there = [p[f"{kernel} other"][key] for p in per_round]
            summary[f"{kernel} {key}"] = {
                "here_faster": sum(a < b for a, b in zip(here, there)), "rounds": rounds,
                "here_median": statistics.median(here), "other_median": statistics.median(there)}
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", required=True, help="checkout whose dyglib_tpu_torch to run")
    ap.add_argument("--out", help="file to save the outputs and times to")
    ap.add_argument("--interleave",
                    help="another checkout: #1' and #1b' at wikipedia in turns with it")
    ap.add_argument("--rounds", type=int, default=10, help="rounds of --interleave")
    ap.add_argument("--compare", help="outputs of another checkout, to compare bit for bit")
    ap.add_argument("--sweep", action="store_true", help="time the wgmma forwards' K splits")
    ap.add_argument("--only", default="", help="comma-separated entries to run (default: all)")
    ap.add_argument("--libs", default="", help="comma-separated libraries to build (default: all)")
    ap.add_argument("--build-log", help="file to write nvcc's full output to")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, args.repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    from dyglib_tpu_torch.ops import _build

    print(card_line(), flush=True)
    libs = [s for s in args.libs.split(",") if s] or list(_build.KERNEL_SOURCES)
    logs = _build.build(libs, ptxas_verbose=True)
    if args.build_log:
        with open(args.build_log, "w") as f:
            f.writelines(f"--- {name}\n{text}\n" for name, text in logs.items())
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    if args.interleave:
        print(json.dumps(interleave(args.interleave, args.rounds)), flush=True)
        return 0
    if not args.out:
        ap.error("--out is required without --interleave")
    only = {s for s in args.only.split(",") if s}
    f32, b16 = run(only, args.sweep)
    torch.save({"f32": f32, "bf16": b16}, args.out)
    ok = all(e["ok"] for e in b16.values())
    for k, (_, ms) in f32.items():
        print(f"{args.repo}: {k} {ms:.4f} ms", flush=True)
    for k, e in b16.items():
        print(f"{args.repo}: {k} {json.dumps(e)}", flush=True)
    if not args.compare:
        return 0 if ok else 1
    other = torch.load(args.compare)
    for k, (ts, ms) in f32.items():
        if k not in other["f32"]:
            continue
        eq = all(torch.equal(a, b) for a, b in zip(ts, other["f32"][k][0]))
        ok = ok and eq
        print(f"{k}: bitwise equal {eq}; {ms:.4f} ms here, {other['f32'][k][1]:.4f} ms there",
              flush=True)
    for k, e in b16.items():
        if k in other["bf16"]:
            print(f"{k}: {e['ms']:.4f} ms here, {other['bf16'][k]['ms']:.4f} ms there",
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
