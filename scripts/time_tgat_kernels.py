#!/usr/bin/env python3
"""Time TGAT's attention and Phi projection kernels on one card, by CUDA-graph replay (device time).

    python3 scripts/time_tgat_kernels.py [--repo DIR] [--rounds N] [--only NAMES]

``--repo`` names the tree whose ``dyglib_tpu_torch`` is imported (default:
this checkout). Two trees timed by one command in turns, parent, change,
change, parent, compare two versions of the kernels on one card.

The inputs are chip_smoke.py's: TGAT at its published widths (K = 20, 2
layers, 2 heads, Dt = 100, features 172), seed-0 weights, the first val
batch's triple (B = 200) sampled from the wikipedia-scale synthetic stream
(157474 edges, seed 1) with its entry table; layer 1's operands at hop 0
(M = 600 queries) and hop 1 (M = 12,000, 240,000 kv rows), keep masks of
dropout p = 0.1 and an output cotangent ~ 1e-3 N(0, 1), from seeded
generators, identical in every tree. At each hop:

  * the three attention forwards, temporal (#5; kv = [random layer-1
    embeddings || the hop's edge rows || Phi(dt)], as chip_smoke.py
    builds them), gathered (#6) and window (#7), and their backwards
    (#5b, #6b, #7b), each by CUDA-graph replay;
  * each backward's launches apart: eager calls traced by torch.profiler,
    device time summed by kernel name: ``head_project_kernel`` (qk, gv),
    ``attention_bwd_query_kernel`` (the per-query kernel),
    ``head_combine_kernel`` (dq3), ``head_weight_grad_kernel`` (dWk, dWv)
    and ``strided_sum_kernel`` (their second pass, and dtw, dtb's);
  * the Phi projection (#8, #8b) on the hop's deltas (R = 12,000 at hop
    0, 240,000 at hop 1) with Wk's Phi rows (a strided view of the
    weight), beside its library yardsticks: ``phi_mm``, torch.mm of a
    precomputed Phi by W, and ``phi_bwd_mms``, the backward's two
    torch.mm's (Phi^T dout, dout W^T); its backward's launches apart too.

``--only`` takes a comma-separated list of measurement names (e.g.
``phi_projection,phi_projection_bwd,phi_mm,phi_bwd_mms``) and times only
those.

Each measurement is taken ``--rounds`` times, in turns with the others.
Prints the card's name and power limit, one line per measurement, then
one JSON line. Needs a CUDA card; raises if the profiler records no device
time.
"""
import argparse
import json
import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from time_dygformer_kernels import graph_ms  # noqa: E402

B, K, DT_DIM, FEAT, DROPOUT = 200, 20, 100, 172, 0.1


def tgat_operands(dev):
    """{hop: {name: zero-argument call}} for hops 0 and 1."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.data import synthetic_link_prediction_data
    from dyglib_tpu_torch.graph import build_temporal_csr
    from dyglib_tpu_torch.graph.csr import time_keys
    from dyglib_tpu_torch.models import TGAT, FeatureTables

    data = synthetic_link_prediction_data(num_src=8227, num_dst=1000, num_edges=157474, seed=1)
    tgat = TGAT(num_neighbors=K, num_layers=2, num_heads=2, time_feat_dim=DT_DIM,
                wants_entry_features=True)
    net = tgat.build(FEAT, FEAT, torch.Generator().manual_seed(0)).to(dev).eval()
    feats = (data.node_raw_features, data.edge_raw_features)
    csr = build_temporal_csr(data.full, num_nodes=data.num_nodes, device=dev, feat_entry_of=feats)
    tables = FeatureTables(*(torch.from_numpy(f).to(dev) for f in feats))
    rng = np.random.RandomState(0)
    ids = np.concatenate([data.val.src[:B], data.val.dst[:B],
                          rng.randint(1, data.num_nodes, B)]).astype(np.int32)
    ts = np.tile(time_keys(data.val.ts[:B]), 3).astype(np.int32)
    inputs = tgat.sample(csr, torch.from_numpy(ids).to(dev), torch.from_numpy(ts).to(dev))
    conv = net.temporal_conv_0
    heads = conv.num_heads
    tw, tb = net.time_encoder.w.detach().reshape(-1), net.time_encoder.b.detach()
    wk, wv = conv.key_projection.weight.detach().t(), conv.value_projection.weight.detach().t()
    dq = wk.shape[1]
    gen = torch.Generator(device=dev).manual_seed(77)
    calls = {}
    with torch.no_grad():
        for h in (0, 1):
            hop_ids = inputs.hop_ids[h].reshape(-1).long()
            m = hop_ids.shape[0]
            dt = (inputs.hop_ts[h].reshape(-1, 1) - inputs.hop_ts[h + 1].reshape(m, K)).float()
            phi0 = net.time_encoder(torch.zeros((m, 1), device=dev))[:, 0, :]
            q3 = conv.query_projection(torch.cat([tables.node[hop_ids], phi0], -1)).contiguous()
            mask = inputs.hop_mask[h].reshape(m, K).float()
            keep = (torch.rand((m, heads, K), device=dev, generator=gen) < 1 - DROPOUT) / (
                1 - DROPOUT)
            dout = 1e-3 * torch.randn((m, dq), device=dev, generator=gen)
            feat_n = tables.node[inputs.hop_ids[h + 1].reshape(-1).long()]
            feat_e = tables.edge[inputs.hop_eids[h].reshape(-1).long()]
            nbr = torch.randn((m, K, FEAT), device=dev, generator=gen)
            edge = feat_e.view(m, K, FEAT)
            phi = net.time_encoder(dt)
            starts = inputs.hop_win_start[h].reshape(-1)
            dt_flat, w_phi = dt.reshape(-1), wk[2 * FEAT:]
            phi_dout = 1e-3 * torch.randn((dt_flat.shape[0], dq), device=dev, generator=gen)
            phi_mat = torch.cos(dt_flat[:, None] * tw + tb)
            p_args = (dt_flat, tw, tb, w_phi)
            t_args = (q3, nbr, edge, phi, mask, keep, wk, wv, heads)
            g_args = (q3, feat_n, feat_e, dt, mask, keep, (tw, tb), (wk, wv), heads)
            w_args = (q3, starts, dt, mask, keep, csr.feat_entry, tw, tb, (wk, wv), heads)
            calls[h] = {
                "temporal_attention": lambda a=t_args: ops.temporal_attention(*a),
                "gathered_attention": lambda a=g_args: ops.gathered_attention(*a),
                "window_attention": lambda a=w_args: ops.window_attention(*a),
                "temporal_attention_bwd": lambda a=t_args, d=dout: ops.temporal_attention_backward(
                    *a[:-1], d, None, a[-1]),
                "gathered_attention_bwd": lambda a=g_args, d=dout:
                    ops.gathered_attention_backward(*a[:-1], d, a[-1]),
                "window_attention_bwd": lambda a=w_args, d=dout: ops.window_attention_backward(
                    *a[:-1], d, a[-1]),
                "phi_projection": lambda a=p_args: ops.phi_projection(*a),
                "phi_projection_bwd": lambda a=p_args, d=phi_dout: ops.phi_projection_backward(
                    *a, d),
                "phi_mm": lambda p=phi_mat, w_=w_phi: torch.mm(p, w_),
                "phi_bwd_mms": lambda p=phi_mat, w_=w_phi, d=phi_dout: (
                    torch.mm(p.t(), d), torch.mm(d, w_.t())),
            }
    return calls


def kernel_name(key: str) -> str:
    """A profiler event's kernel name without its namespaces, template
    arguments and parameters."""
    name = key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return name.split("::")[-1].split(" ")[-1] or key


def launch_split(fn, calls: int = 5) -> dict:
    """Device ms per call of each kernel a backward launches, by name, from
    a profiler trace of ``calls`` eager calls (after one warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split, total = {}, 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        total += us
        name = kernel_name(evt.key)
        split[name] = split.get(name, 0.0) + us / calls / 1e3
    if total <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    return split


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=REPO_ROOT,
                        help="tree whose dyglib_tpu_torch is timed (default: this checkout)")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--only", default="",
                        help="comma-separated measurement names to time (default: all)")
    args = parser.parse_args()
    only = set(filter(None, args.only.split(",")))
    import torch

    if not torch.cuda.is_available():
        print("time_tgat_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"timing {os.path.abspath(ops.__file__)}", flush=True)
    _build.build(["temporal_attention", "gathered_attention", "window_attention",
                  "phi_projection"])
    dev = torch.device("cuda:0")
    results = {}
    for h, calls in tgat_operands(dev).items():
        calls = {name: fn for name, fn in calls.items() if not only or name in only}
        entry = {name: [] for name in calls}
        entry.update({f"{name}_launches": [] for name in calls if name.endswith("_bwd")})
        order = list(calls)
        for r in range(args.rounds):
            for name in order if r % 2 == 0 else order[::-1]:
                entry[name].append(graph_ms(calls[name], 5 if h else 20))
                if name.endswith("_bwd"):
                    entry[f"{name}_launches"].append(launch_split(calls[name]))
        results[f"hop{h}"] = entry
        for name, times in entry.items():
            if name.endswith("_launches"):
                for split in times:
                    print(f"hop {h} {name:<32} " + "  ".join(
                        f"{k.removesuffix('_kernel')} {v:.5f}" for k, v in split.items()),
                        flush=True)
            else:
                print(f"hop {h} {name:<32} device {['%.5f' % t for t in times]} ms", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "repo": os.path.abspath(args.repo), "device_ms": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
