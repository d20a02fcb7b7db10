#!/usr/bin/env python3
"""The f32 time-channel kernels of two checkouts, bit for bit, on one card.

    python3 scripts/time_channel_bits.py --repo DIR --out FILE.pt
    python3 scripts/time_channel_bits.py --repo DIR --out FILE.pt --compare OTHER.pt

Builds the port's kernels from ``DIR`` (its own ``dyglib_tpu_torch/build``)
and runs the split-TF32 time channel forward (#1) and backward (#1b), and
the Phi projection's backward (which shares #1b's kernel without the mask
and dbias), on inputs drawn from seed 2468 at the shapes of chip_smoke.py:
DyGFormer wikipedia (600 rows of 32 positions, patch 1) and CanParl (600
rows of 2048, patch 64), Dt 100, ced 50; the Phi projection at 240,000
rows (TGAT's hop-1 deltas), dq 272. It saves every
output to ``FILE.pt`` with each kernel's ms (CUDA events, median of 5
repeats). With ``--compare`` it prints, per output, whether it equals
OTHER's bit for bit, and both times; it exits 1 if any output differs.
Run it for two checkouts in one call, in turns (parent, change, change,
parent), to compare their times on one card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys


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


def run() -> dict:
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.nn.modules import time_encoder_spectrum

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(2468)
    dt_dim, ced, m = 100, 50, 600
    tw = torch.from_numpy(time_encoder_spectrum(dt_dim)).reshape(-1).to(dev)
    tb = 0.1 * torch.randn(dt_dim, device=dev, generator=gen)
    out = {}
    for config, lp, patch in (("wikipedia", 32, 1), ("CanParl", 2048, 64)):
        dt = torch.randint(0, 1_000_000, (m, lp), device=dev, generator=gen).float()
        valid = torch.rand((m, lp), device=dev, generator=gen) < 0.8
        k = patch * dt_dim
        w = ((torch.rand((ced, k), device=dev, generator=gen) * 2 - 1) * k**-0.5).t()
        bias = (torch.rand(ced, device=dev, generator=gen) * 2 - 1) * k**-0.5
        dout = 1e-3 * torch.randn((m, lp // patch, ced), device=dev, generator=gen)
        fwd = lambda: ops.time_channel_projection(dt, valid, tw, tb, w, bias, patch)
        bwd = lambda: ops.time_channel_backward(dt, valid, tw, tb, w, dout, patch)
        iters = 20 if lp > 100 else 200
        out[f"time_channel@{config}"] = ([fwd()], cuda_ms(fwd, iters))
        out[f"time_channel_bwd@{config}"] = (list(bwd()), cuda_ms(bwd, iters // 2))
    rows, dq = 240_000, 272
    dt = torch.rand(rows, device=dev, generator=gen) * 1e5
    w = (torch.rand((dt_dim, dq), device=dev, generator=gen) * 2 - 1) * dt_dim**-0.5
    dout = 1e-3 * torch.randn((rows, dq), device=dev, generator=gen)
    bwd = lambda: ops.phi_projection_backward(dt, tw, tb, w, dout)
    out["phi_projection_bwd@tgat"] = (list(bwd()), cuda_ms(bwd, 50))
    torch.cuda.synchronize()
    return {k: ([t.cpu() for t in ts], ms) for k, (ts, ms) in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", required=True, help="checkout whose dyglib_tpu_torch to run")
    ap.add_argument("--out", required=True, help="file to save the outputs and times to")
    ap.add_argument("--compare", help="outputs of another checkout, to compare bit for bit")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_channel_bits: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, args.repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    res = run()
    torch.save(res, args.out)
    for k, (_, ms) in res.items():
        print(f"{args.repo}: {k} {ms:.4f} ms", flush=True)
    if not args.compare:
        return 0
    other = torch.load(args.compare)
    same = True
    for k, (ts, ms) in res.items():
        eq = all(torch.equal(a, b) for a, b in zip(ts, other[k][0]))
        same = same and eq
        print(f"{k}: bitwise equal {eq}; {ms:.4f} ms here, {other[k][1]:.4f} ms there",
              flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
