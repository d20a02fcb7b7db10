#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py            (from the root of a checkout)

The main path is DyGFormer link-prediction evaluation
(``dyglib_tpu_torch.train.LinkPredictionTrainer.evaluate``) at the model's
published widths (channel embedding 50, time features 100, 2 layers,
2 heads, node and edge features 172), random weights from seed 0, on the
wikipedia-scale synthetic stream (8227 users, 1000 items, 157474 edges,
seed 1) built in memory, B = 200, random negatives on the val split, at
two published configurations: wikipedia (maxlen 32, patch 1) and CanParl
(maxlen 2048, patch 64).

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):
  1. require a CUDA card and the package beside this script; print the
     card's name and power limit as nvidia-smi reports them;
  2. build the three CUDA kernels from dyglib_tpu_torch/csrc (one nvcc per
     source, all at once) and print the build time and ptxas's report;
  3. at the shapes the main path gives each kernel, hold the kernel to its
     plain PyTorch version on the card (stated tolerances) and time the
     kernel, the plain version and, where one exists, one PyTorch library
     call computing the same function; compute each bound from bytes and
     operations;
  4. for each configuration: zero the launch counters, run evaluate on the
     val batches through the kernels, read the counters (every kernel must
     have launched), check the probabilities are finite and the metrics in
     range; hold one batch's embeddings through the kernels to those
     through the plain versions; run the same batches in turns, plain,
     plain, kernels (so the kernel path is timed in sweeps 1 and 4 and the
     plain path in sweeps 2 and 3, against the drift of the host clock),
     and require every sweep's probabilities to agree with the first; at
     wikipedia also hold the first batches to the port's CPU path (the
     path the CPU tests hold to the JAX package);
  5. print one JSON line of kernel numbers, then the device JSON line.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (float32 and int32 on CUDA cores; HBM3)
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# kernel vs plain version, f32: the two differ only in the order of their
# f32 sums (K <= 11008 products of O(1) values), ~1e-6 in practice
KERNEL_ATOL = 1e-4
# evaluate probabilities, kernel path vs plain path (and vs the CPU path):
# the embeddings differ by the same sum-order noise; the sigmoid's slope is
# at most 1/4
PROB_ATOL = 1e-4

B = 200
CONFIGS = (  # (name, maxlen, patch, val batches driven)
    ("wikipedia", 32, 1, 40),
    ("CanParl", 2048, 64, 10),
)
CED, DT_DIM, FEAT = 50, 100, 172


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(dev) -> dict:
    """Phase 3: each kernel against its plain version at the main path's
    shapes, with times. Returns {(kernel, config): measurements}."""
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.nn.modules import time_encoder_spectrum

    gen = torch.Generator(device=dev).manual_seed(1234)
    m = 3 * B  # triple: [src || dst || neg_dst]
    results = {}

    def record(key, part, err, ms, plain, lib, nbytes, nops):
        entry = results.setdefault(key, {"parts": []})
        entry["parts"].append(
            dict(part=part, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                 bytes=nbytes, ops=nops)
        )
        log(f"  {key[0]:<16} {key[1]:<9} {part:<26} err {err:.3g}  kernel {ms:.4f} ms  "
            f"plain {plain:.4f} ms  library {lib if lib is None else round(lib, 4)} ms")

    for config, maxlen, patch, _ in CONFIGS:
        lp = maxlen
        rows = m * (lp // patch)
        iters = 20 if lp > 100 else 200
        # ---- time channel: dt as the synthetic stream's integer deltas
        dt = torch.randint(0, 1_000_000, (m, lp), device=dev, generator=gen).float()
        valid = torch.rand((m, lp), device=dev, generator=gen) < 0.8
        tw = torch.from_numpy(time_encoder_spectrum(DT_DIM)).reshape(-1).to(dev)
        tb = 0.1 * torch.randn(DT_DIM, device=dev, generator=gen)
        k = patch * DT_DIM
        # w as the model passes it: nn.Linear's (ced, K) weight, transposed
        w = ((torch.rand((CED, k), device=dev, generator=gen) * 2 - 1) * k**-0.5).t()
        bias = (torch.rand(CED, device=dev, generator=gen) * 2 - 1) * k**-0.5
        args = (dt, valid, tw, tb, w, bias, patch)
        out = ops.time_channel_projection(*args)
        ref = ops.time_channel_projection_plain(*args)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not (out.shape == ref.shape == (m, lp // patch, CED)) or not err <= KERNEL_ATOL:
            raise AssertionError(f"time_channel@{config}: max abs err {err} > {KERNEL_ATOL}")

        def library_time_channel():
            phi = torch.where(valid[..., None], torch.cos(dt[..., None] * tw + tb), 0.0)
            return torch.addmm(bias, phi.view(rows, k), w)

        record(
            ("time_channel", config), f"M{m} L{lp} patch{patch}", err,
            cuda_ms(lambda: ops.time_channel_projection(*args), iters),
            cuda_ms(lambda: ops.time_channel_projection_plain(*args), iters),
            cuda_ms(library_time_channel, iters),
            4 * m * lp + m * lp + 4 * (2 * DT_DIM + k * CED + CED + rows * CED),
            2 * rows * k * CED + 3 * m * lp * DT_DIM,
        )
        del dt, valid, out, ref

        # ---- patch projection: gathered 172-wide feature rows, pads zero
        x = torch.randn((m, lp, FEAT), device=dev, generator=gen)
        x[:, lp // 2 :, :] = 0.0
        k = patch * FEAT
        w = ((torch.rand((CED, k), device=dev, generator=gen) * 2 - 1) * k**-0.5).t()
        bias = (torch.rand(CED, device=dev, generator=gen) * 2 - 1) * k**-0.5
        out = ops.patch_projection(x, w, bias, patch)
        ref = ops.patch_projection_plain(x, w, bias, patch)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not (out.shape == ref.shape == (m, lp // patch, CED)) or not err <= KERNEL_ATOL:
            raise AssertionError(f"patch_projection@{config}: max abs err {err} > {KERNEL_ATOL}")
        x2 = x.view(rows, k)
        record(
            ("patch_projection", config), f"M{m} Lp{lp} D{FEAT} patch{patch}", err,
            cuda_ms(lambda: ops.patch_projection(x, w, bias, patch), iters),
            cuda_ms(lambda: ops.patch_projection_plain(x, w, bias, patch), iters),
            cuda_ms(lambda: torch.addmm(bias, x2, w), iters),
            4 * (m * lp * FEAT + k * CED + CED + rows * CED),
            2 * rows * k * CED,
        )
        del x, x2, out, ref

        # ---- co-occurrence: one self launch (src once + the 2B right
        # rows = 3B rows, q = k) and one cross launch (4B rows, k = partner)
        ids = torch.randint(1, 400, (4 * B, lp), device=dev, generator=gen, dtype=torch.int32)
        ids[:, lp // 2 :] = 0
        partner = torch.cat([ids[2 * B :], ids[: 2 * B]])
        for part, q, kk in (
            (f"self R{3 * B} L{lp}", ids[: 3 * B], ids[: 3 * B]),
            (f"cross R{4 * B} L{lp}", ids, partner),
        ):
            q, kk = q.contiguous(), kk.contiguous()
            out = ops.cooccurrence_counts(q, kk)
            ref = ops.cooccurrence_counts_plain(q, kk)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            if not err == 0.0:
                raise AssertionError(f"cooccurrence@{config} {part}: counts differ by {err}")
            r, l = q.shape
            # operations: the least work that gives the counts, a sort of
            # each row's keys and two binary searches per query
            # (l log2 l + 2 l log2 l compares per row)
            record(
                ("cooccurrence", config), part, err,
                cuda_ms(lambda: ops.cooccurrence_counts(q, kk), iters),
                cuda_ms(lambda: ops.cooccurrence_counts_plain(q, kk), max(2, iters // 10)),
                None,
                4 * (3 * r * l), 3 * r * l * math.log2(l),
            )
        del ids, partner
        torch.cuda.empty_cache()
    return results


def max_prob_diff(probs, other) -> float:
    """Largest |p - q| over two evaluate runs' per-batch (pos, neg) arrays."""
    import numpy as np

    return max(
        float(np.abs(x - y).max()) for ours, theirs in zip(probs, other)
        for x, y in zip(ours, theirs)
    )


def run_config(data, config, maxlen, patch, n_batches, dev, cpu_reference: bool) -> dict:
    """Phase 4 for one configuration."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.graph.csr import time_keys
    from dyglib_tpu_torch.models import DyGFormer
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    backbone = DyGFormer(
        max_input_sequence_length=maxlen, patch_size=patch, channel_embedding_dim=CED,
        num_layers=2, num_heads=2, time_feat_dim=DT_DIM,
    )
    tr = LinkPredictionTrainer(backbone, data, TrainConfig(batch_size=B), device=dev)
    tr.init_params(0)
    stream = data.val.slice(0, n_batches * B)
    for use_kernels in (False, True):  # warm-up of both paths: allocator, cuBLAS
        tr.model.use_kernels = use_kernels
        tr.evaluate(data.val.slice(0, B), tr.val_neg)
    torch.cuda.synchronize()

    def sweep(use_kernels: bool):
        """One timed evaluate over the batches; returns its launch counts,
        seconds and (losses, metrics, probs)."""
        tr.model.use_kernels = use_kernels
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = tr.evaluate(stream, tr.val_neg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return ops.launch_counts(), seconds, out

    # the main path: counters zeroed just before, read just after
    launches, kernel_s, (losses, metrics, probs) = sweep(True)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"{config}: kernels never launched on the main path: {missing}")
    if len(probs) != n_batches:
        raise AssertionError(f"{config}: {len(probs)} batches, expected {n_batches}")
    for pos, neg in probs:
        if pos.shape != (B,) or neg.shape != (B,) or not (
            np.isfinite(pos).all() and np.isfinite(neg).all()
        ):
            raise AssertionError(f"{config}: probabilities malformed or not finite")
    mean = tr.mean_metrics(metrics)
    if not all(0.0 <= v <= 1.0 for v in mean.values()) or not np.isfinite(losses).all():
        raise AssertionError(f"{config}: metrics out of range {mean}")

    # one batch's embeddings, kernel path vs plain path (the probabilities
    # below can round a small embedding difference away)
    batch_ids = torch.from_numpy(
        np.concatenate([stream.src[:B], stream.dst[:B], stream.dst[B - 1 :: -1]]).astype(np.int32)
    ).to(dev)
    batch_ts = torch.from_numpy(time_keys(stream.ts[:B]).astype(np.int32)).to(dev).repeat(3)
    with torch.inference_mode():
        inputs = backbone.sample(tr.full_csr, batch_ids, batch_ts)
        emb_kernel = tr.model(tr.tables, inputs, triple=True)
        tr.model.use_kernels = False
        emb_plain = tr.model(tr.tables, inputs, triple=True)
    emb_diff = (emb_kernel - emb_plain).abs().max().item()
    if not emb_diff <= KERNEL_ATOL:
        raise AssertionError(f"{config}: kernel vs plain embeddings differ by {emb_diff}")

    # the same batches in turns: plain, plain, kernels
    kernel_ms, plain_ms, diff = [kernel_s / n_batches * 1e3], [], 0.0
    for use_kernels in (False, False, True):
        counts, seconds, (_, _, other) = sweep(use_kernels)
        if use_kernels and counts != launches:
            raise AssertionError(f"{config}: kernel sweeps launched {counts} vs {launches}")
        if not use_kernels and any(counts.values()):
            raise AssertionError(f"{config}: the plain path launched a kernel: {counts}")
        (kernel_ms if use_kernels else plain_ms).append(seconds / n_batches * 1e3)
        diff = max(diff, max_prob_diff(probs, other))
    if not diff <= PROB_ATOL:
        raise AssertionError(f"{config}: kernel vs plain probabilities differ by {diff}")

    result = dict(
        config=config, maxlen=maxlen, patch=patch, batches=n_batches, launches=launches,
        kernel_ms_per_batch=kernel_ms, plain_ms_per_batch=plain_ms,
        average_precision=mean["average_precision"], roc_auc=mean["roc_auc"],
        max_prob_diff_vs_plain=diff, max_embedding_diff_vs_plain=emb_diff,
    )
    if cpu_reference:
        n_cpu = 2
        cpu = LinkPredictionTrainer(backbone, data, TrainConfig(batch_size=B), device="cpu")
        cpu.load_params({
            "backbone": {k: v.cpu() for k, v in tr.model.state_dict().items()},
            "head": {k: v.cpu() for k, v in tr.head.state_dict().items()},
        })
        _, _, cpu_probs = cpu.evaluate(data.val.slice(0, n_cpu * B), cpu.val_neg)
        cdiff = max_prob_diff(probs[:n_cpu], cpu_probs)
        if not cdiff <= PROB_ATOL:
            raise AssertionError(f"{config}: card vs CPU probabilities differ by {cdiff}")
        result["max_prob_diff_vs_cpu"] = cdiff
    log(f"  {json.dumps(result)}")
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO_ROOT, "dyglib_tpu_torch")):
        print("chip_smoke: the dyglib_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO_ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    # ---- 1. the card
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- 2. build
    from dyglib_tpu_torch.ops import _build

    t0 = time.perf_counter()
    build_logs = _build.build(ptxas_verbose=True)
    log(f"built {sorted(build_logs)} in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- 3. kernels against their plain versions
    log("kernels vs plain versions (tolerance: time_channel and patch_projection "
        f"atol {KERNEL_ATOL}, cooccurrence exact):")
    kernel_results = check_kernels(dev)

    # ---- 4. the main path
    from dyglib_tpu_torch.data import synthetic_link_prediction_data

    t0 = time.perf_counter()
    data = synthetic_link_prediction_data(num_src=8227, num_dst=1000, num_edges=157474, seed=1)
    log(f"synthetic stream: {data.full.num_interactions} edges, val "
        f"{data.val.num_interactions}, built in {time.perf_counter() - t0:.1f} s")
    log(f"main path (probability tolerance {PROB_ATOL}):")
    runs = {}
    for config, maxlen, patch, n_batches in CONFIGS:
        runs[config] = run_config(
            data, config, maxlen, patch, n_batches, dev, cpu_reference=config == "wikipedia"
        )

    # ---- 5. results
    rows = []
    replaces = {
        "time_channel": "dyglib_tpu/ops/pallas/time_channel.py:119",
        "cooccurrence": "dyglib_tpu/ops/pallas/cooccurrence.py:35",
        "patch_projection": "dyglib_tpu/ops/pallas/patch_projection.py:59",
    }
    for (kernel, config), entry in kernel_results.items():
        parts = entry["parts"]
        nbytes = sum(p["bytes"] for p in parts)
        nops = sum(p["ops"] for p in parts)
        b_ms, b_by = bound_ms(nbytes, nops)
        libs = [p["library_ms"] for p in parts]
        rows.append({
            "name": f"{kernel}@{config}",
            "route": "cuda",
            "source": f"dyglib_tpu_torch/csrc/{kernel}.cu",
            "replaces": replaces[kernel],
            "launches": runs[config]["launches"][kernel],
            "max_abs_err": max(p["max_abs_err"] for p in parts),
            "ms": sum(p["ms"] for p in parts),
            "plain_ms": sum(p["plain_ms"] for p in parts),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None if None in libs else sum(libs),
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
