#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA H100 and check them.

    python3 chip_smoke.py            (from the root of a checkout)

The main paths are TGAT and DyGFormer link-prediction evaluation
(``dyglib_tpu_torch.train.LinkPredictionTrainer.evaluate``) and training
(``LinkPredictionTrainer.train_step`` over train batches, and ``fit``),
each model at its published widths (TGAT: 20
neighbours, 2 layers, 2 heads; DyGFormer: channel embedding 50, 2 layers,
2 heads; both: time features 100, node and edge features 172), random
weights from seed 0, on the wikipedia-scale synthetic stream (8227 users,
1000 items, 157474 edges, seed 1) built in memory, B = 200; DyGFormer at
two published configurations: wikipedia (maxlen 32, patch 1) and CanParl
(maxlen 2048, patch 64).

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):
  1. require a CUDA card and the package beside this script; print the
     card's name and power limit as nvidia-smi reports them;
  2. build the CUDA kernels from dyglib_tpu_torch/csrc (one nvcc per
     source, all at once) and print the build time and ptxas's report;
  3. at the shapes the main paths give each kernel (M = 600 rows of the
     B = 200 triple; TGAT's layer 1 at hop 1: 12,000 queries, 240,000 kv
     rows), hold the kernel to its plain PyTorch version on the card
     (stated tolerances) and time the kernel, the plain version and,
     where one exists, one PyTorch library call computing the same
     function (for TGAT's attention kernels only a part of it, the K/V
     products); the patch projection's and the time channel's forward
     and backward launched twice, bitwise equal; compute each bound
     from bytes and operations (the patch projection's, the time
     channel's and the Phi projection's: three TF32 passes at the tensor
     cores' peak, and for the time channel and the Phi projection their
     cosines (and the backwards' sines) at the SFU's rate, the Phi
     projection at R = 12,000 and 240,000, its two launches bitwise
     equal; every other kernel's at the f32 peak; for TGAT's
     attention kernels, the operations the function needs, reassociated
     as the kernels compute it: no kv row projected; their forwards
     launched twice, bitwise equal); the same for TGAT's four backward
     kernels at its training shapes (gradients within GRAD_RTOL of their sums of
     |terms|, a second launch bitwise equal to the first; library
     yardsticks partial: the two weight-gradient products);
  4. TGAT evaluation on the first val batches, one set of weights in four
     configurations (plain versions; default kernels: gathered attention
     at layer 1, fused attention at layer 2; window attention with the
     entry table; the Phi projection), swept in turns, forward and back:
     zero the launch counters before each sweep and read them after (each
     configuration launches exactly its kernels, a fixed number a batch),
     finite probabilities, metrics in range, every sweep within the
     probability tolerance of the first plain sweep, one batch's
     embeddings through the kernels vs the plain versions, and the first
     batches vs the port's CPU path; ms per eval batch for each;
  4b. DyGFormer evaluation, for each configuration: zero the launch counters, run
     evaluate on the val batches through the kernels, read the counters
     (every forward kernel must have launched), check the probabilities
     are finite and the metrics in range; hold one batch's embeddings
     through the kernels to those through the plain versions; run the same
     batches in turns, plain, plain, kernels, and require every sweep's
     probabilities to agree with the first; at wikipedia also hold the
     first batches to the port's CPU path;
  5. training, for each configuration (wikipedia on the gather path,
     CanParl with use_entry_fetch): the last train batches (so that CanParl
     picks its full 2048 bucket), dropout 0, the same steps from the same
     parameters in sweeps of kernels, plain, plain, kernels: zero the
     counters before each sweep and read them after (every kernel of the
     path launched on the kernel path, none on the plain path), require
     finite gradients for every parameter, per-step losses and final
     parameters that agree; the two paths in lockstep (losses within
     LOSS_ATOL, gradients within GRAD_STEP_RTOL; the link head's ReLU
     inputs whose sign differs between them counted); then the kernel path
     with the other feature
     fetch (entry fetch at wikipedia, gather at CanParl) in turns with the
     first, for their step times;
  5t. TGAT training over the last train batches, one set of seed-0
     weights in the four evaluation configurations, swept in turns (plain,
     default, window, Phi fusion, and back), dropout 0: zero the launch
     counters before each sweep and read them after (each configuration
     launches exactly its forward and backward kernels, a fixed number a
     step; the plain one none), finite gradients for every parameter, ms
     per train step; then each kernel configuration in lockstep with its
     plain versions (losses within LOSS_ATOL, gradients within
     GRAD_STEP_RTOL of each tensor's largest entry but the time encoder's
     frequencies, which phase 3 holds to their sums of |terms|; the merge
     layers' and the link head's ReLU inputs whose sign differs between
     the two paths counted, each required within FLIP_ATOL of zero, and
     the plain path given the kernel path's value there with an identity
     gradient, so both take the same branch: kernel_side), and one
     lockstep step at dropout 0.1 (the same dropout_gen seed for both
     paths: the keep masks go through the backward kernels);
  5u. TGAT with the uniform strategy (default kernels): a few train steps
     (its kernels launch, forward and backward), then two evaluate sweeps
     over the first val batches with identical probabilities;
  6. fit on the JAX test fixture (the 2000-edge synthetic stream of
     tests/conftest.py): DyGFormer 32/2, 2 layers, dropout 0.1, 4 epochs,
     lr 5e-4, test AP above 0.50 and the least epoch loss below 0.67
     (tests/test_remaining_models.py); TGAT K = 10, 2 layers, 4 epochs,
     lr 1e-3, default kernels, test AP above 0.58 and AUC above 0.57
     (tests/test_tgat_end_to_end.py): the JAX package's floors;
  7. print one JSON line of kernel numbers, then the device JSON line.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (float32 and int32 on CUDA cores; TF32 on the
# tensor cores, dense; HBM3)
PEAK_F32_OPS = 67e12
PEAK_TF32_OPS = 495e12
PEAK_BYTES = 3.35e12
# the SFU's cosines: 16 a clock on each of 132 SMs at the 1.98 GHz boost
PEAK_SFU_OPS = 16 * 132 * 1.98e9
# the patch projection's, the time channel's and the Phi projection's
# kernels multiply on the tensor cores in three TF32 passes (split
# operands, f32 accuracy): their operations are 3x the product's, at the
# TF32 peak
SPLIT_TF32_PASSES = 3
# kernel vs plain version, f32: the two differ only in the order of their
# f32 sums (K <= 11008 products of O(1) values), ~1e-6 in practice
KERNEL_ATOL = 1e-4
# evaluate probabilities, kernel path vs plain path (and vs the CPU path):
# the embeddings differ by the same sum-order noise; the sigmoid's slope is
# at most 1/4
PROB_ATOL = 1e-4
# backward kernels vs plain versions: every gradient entry is a sum over
# rows (and patch slots), 19,200 or 1.2 M f32 terms, that the two take in
# different orders; the difference is held to this share of the sum of the
# absolute values of its terms. dtw's terms are scaled by dt up to 1e6, so
# no fixed atol fits it.
GRAD_RTOL = 3e-5
# training, kernel path vs plain path, dropout 0.
# In lockstep (both paths' loss and gradients from the same parameters at
# every step, then the kernel path's step): losses within LOSS_ATOL (the
# forwards differ by sum-order noise, ~1e-6) and every gradient but the
# time encoder's frequencies within GRAD_STEP_RTOL of its tensor's largest
# entry (the kernels sum their rows in another order than cuBLAS). The
# frequencies' gradient (dtw) is a sum of terms scaled by dt up to 1e6 that
# cancel; the kernel phase holds it to its sum of |terms| instead.
# Free-running (each path its own N steps from the same start): the first
# loss within LOSS_ATOL, the later ones within LOSS_DRIFT_ATOL, the final
# parameters within 2 * steps * lr. Adam moves every frequency by ~lr a
# step whatever its gradient's size, and lr * dt reaches 100 rad, so the
# two paths' high-frequency time features decorrelate after one step and
# the losses drift apart (0.0048 over 10 wikipedia steps on the H100,
# PERF.md); the parameters stay within the ~lr-a-step bound.
LOSS_ATOL = 1e-4
GRAD_STEP_RTOL = 1e-3
# TGAT's lockstep: a ReLU input that takes another sign on the two paths
# must lie this close to zero on both (the forwards differ by ~3e-7 at
# most, PERF.md); the plain path then takes the kernel path's value there
FLIP_ATOL = 1e-5
LOSS_DRIFT_ATOL = 0.05
TRAIN_LR = 1e-4
# end-metric floors of the fixture fits (tests/test_remaining_models.py,
# tests/test_tgat_end_to_end.py) and the JAX package's bands there
# (tests/calibration_fixture.json)
FIT_AP_FLOOR, FIT_LOSS_CEIL, FIT_BAND = 0.50, 0.67, (0.6368, 0.0438)
TGAT_FIT_AP_FLOOR, TGAT_FIT_AUC_FLOOR, TGAT_FIT_BAND = 0.58, 0.57, (0.6171, 0.0078)

B = 200
CONFIGS = (  # (name, maxlen, patch, val batches driven, train steps driven)
    ("wikipedia", 32, 1, 40, 10),
    ("CanParl", 2048, 64, 10, 5),
)
CED, DT_DIM, FEAT = 50, 100, 172
# the kernels of the evaluation path (the training path adds the backward
# kernels, and window_fetch with the entry fetch)
EVAL_KERNELS = ("time_channel", "cooccurrence", "patch_projection")
# TGAT at its published widths (best_configs.py: K = 20 neighbours, 2
# layers; 2 heads, Dt = 100, features 172), evaluated on the first val
# batches in four configurations: (TGAT kwargs, use_kernels, the kernels
# that must launch and their launches per batch: layer 1 runs on hops 0
# and 1, layer 2 on hop 0; the Phi projection runs twice per convolution)
TGAT_K, TGAT_BATCHES = 20, 20
TGAT_CONFIGS = {
    "plain": ({}, False, {}),
    "default": ({}, True, {"gathered_attention": 2, "temporal_attention": 1}),
    "window": (dict(wants_entry_features=True), True,
               {"window_attention": 2, "temporal_attention": 1}),
    "phi_fusion": (dict(use_phi_fusion=True), True, {"phi_projection": 6}),
}
# the configuration whose sweep counts each TGAT kernel's main-path launches
# (forward kernels: its evaluation sweep; backward kernels: its training
# sweep)
TGAT_KERNEL_CONFIG = {"temporal_attention": "default", "gathered_attention": "default",
                      "window_attention": "window", "phi_projection": "phi_fusion"}
# TGAT training: the last train batches, dropout 0 (and one lockstep step at
# the published dropout)
TGAT_TRAIN_STEPS, TGAT_DROPOUT = 5, 0.1


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


def bound_ms(nbytes: float, ops: float, ops_peak: float = PEAK_F32_OPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / ops_peak * 1e3
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

    def record(key, part, err, ms, plain, lib, nbytes, nops, ops_peak=PEAK_F32_OPS, sfu=0):
        entry = results.setdefault(key, {"parts": []})
        entry["parts"].append(
            dict(part=part, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                 bytes=nbytes, ops=nops, ops_peak=ops_peak, sfu_ops=sfu)
        )
        log(f"  {key[0]:<16} {key[1]:<9} {part:<26} err {err:.3g}  kernel {ms:.4f} ms  "
            f"plain {plain:.4f} ms  library {lib if lib is None else round(lib, 4)} ms")

    for config, maxlen, patch, _, _ in CONFIGS:
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
        again = ops.time_channel_projection(*args)
        ref = ops.time_channel_projection_plain(*args)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not (out.shape == ref.shape == (m, lp // patch, CED)) or not err <= KERNEL_ATOL:
            raise AssertionError(f"time_channel@{config}: max abs err {err} > {KERNEL_ATOL}")
        if not torch.equal(out, again):
            raise AssertionError(f"time_channel@{config}: a second launch differs")
        n_valid = int(valid.sum())

        def library_time_channel():
            phi = torch.where(valid[..., None], torch.cos(dt[..., None] * tw + tb), 0.0)
            return torch.addmm(bias, phi.view(rows, k), w)

        # split TF32 on the tensor cores: three passes of the product; one
        # cosine per valid (position, feature), at the SFU's rate
        record(
            ("time_channel", config), f"M{m} L{lp} patch{patch}", err,
            cuda_ms(lambda: ops.time_channel_projection(*args), iters),
            cuda_ms(lambda: ops.time_channel_projection_plain(*args), iters),
            cuda_ms(library_time_channel, iters),
            4 * m * lp + m * lp + 4 * (2 * DT_DIM + k * CED + CED + rows * CED),
            SPLIT_TF32_PASSES * 2 * rows * k * CED, PEAK_TF32_OPS, sfu=n_valid * DT_DIM,
        )
        del dt, valid, out, again, ref

        # ---- patch projection: gathered 172-wide feature rows, pads zero
        x = torch.randn((m, lp, FEAT), device=dev, generator=gen)
        x[:, lp // 2 :, :] = 0.0
        k = patch * FEAT
        w = ((torch.rand((CED, k), device=dev, generator=gen) * 2 - 1) * k**-0.5).t()
        bias = (torch.rand(CED, device=dev, generator=gen) * 2 - 1) * k**-0.5
        out = ops.patch_projection(x, w, bias, patch)
        again = ops.patch_projection(x, w, bias, patch)
        ref = ops.patch_projection_plain(x, w, bias, patch)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not (out.shape == ref.shape == (m, lp // patch, CED)) or not err <= KERNEL_ATOL:
            raise AssertionError(f"patch_projection@{config}: max abs err {err} > {KERNEL_ATOL}")
        if not torch.equal(out, again):
            raise AssertionError(f"patch_projection@{config}: a second launch differs")
        x2 = x.view(rows, k)
        # split TF32 on the tensor cores: three passes of the product
        record(
            ("patch_projection", config), f"M{m} Lp{lp} D{FEAT} patch{patch}", err,
            cuda_ms(lambda: ops.patch_projection(x, w, bias, patch), iters),
            cuda_ms(lambda: ops.patch_projection_plain(x, w, bias, patch), iters),
            cuda_ms(lambda: torch.addmm(bias, x2, w), iters),
            4 * (m * lp * FEAT + k * CED + CED + rows * CED),
            SPLIT_TF32_PASSES * 2 * rows * k * CED, PEAK_TF32_OPS,
        )
        del x, x2, out, again, ref

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


def grad_errors(got, want, terms) -> tuple[float, float]:
    """(largest |kernel - plain|, largest |kernel - plain| / sum|terms|)
    over the entries of a list of gradients."""
    diffs = [(g - w).abs() for g, w in zip(got, want)]
    return (
        max(d.max().item() for d in diffs),
        max((d / t.clamp_min(1e-30)).max().item() for d, t in zip(diffs, terms)),
    )


def check_training_kernels(dev) -> dict:
    """Phase 3, the training path's kernels: the two backward kernels and
    the entry-window fetch, at each configuration's training shapes."""
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.nn.modules import time_encoder_spectrum

    gen = torch.Generator(device=dev).manual_seed(4321)
    m = 3 * B
    results = {}

    def record(key, part, err, rel, ms, plain, lib, nbytes, nops, ops_peak=PEAK_F32_OPS, sfu=0):
        results[key] = {"parts": [dict(part=part, max_abs_err=err, ms=ms, plain_ms=plain,
                                       library_ms=lib, bytes=nbytes, ops=nops,
                                       ops_peak=ops_peak, sfu_ops=sfu)]}
        log(f"  {key[0]:<20} {key[1]:<9} {part:<26} err {err:.3g} ({rel:.3g} of sum|terms|)  "
            f"kernel {ms:.4f} ms  plain {plain:.4f} ms  "
            f"library {lib if lib is None else round(lib, 4)} ms")

    for config, maxlen, patch, _, _ in CONFIGS:
        lp = maxlen
        rows = m * (lp // patch)
        iters = 10 if lp > 100 else 100
        # ---- time channel backward
        dt = torch.randint(0, 1_000_000, (m, lp), device=dev, generator=gen).float()
        valid = torch.rand((m, lp), device=dev, generator=gen) < 0.8
        tw = torch.from_numpy(time_encoder_spectrum(DT_DIM)).reshape(-1).to(dev)
        tb = 0.1 * torch.randn(DT_DIM, device=dev, generator=gen)
        k = patch * DT_DIM
        w = ((torch.rand((CED, k), device=dev, generator=gen) * 2 - 1) * k**-0.5).t()
        dout = 1e-3 * torch.randn((m, lp // patch, CED), device=dev, generator=gen)
        args = (dt, valid, tw, tb, w, dout, patch)
        got = ops.time_channel_backward(*args)
        again = ops.time_channel_backward(*args)
        want = ops.time_channel_backward_plain(*args)
        # the same sums over |operands|: each entry's sum of |terms|
        theta = dt[..., None] * tw + tb
        mask = valid[..., None]
        g_abs = dout.reshape(rows, CED).abs()
        phi_abs = torch.where(mask, torch.cos(theta).abs(), 0.0).reshape(rows, k)
        common = torch.where(
            mask, (g_abs @ w.abs().t()).reshape(theta.shape) * torch.sin(theta).abs(), 0.0
        )
        terms = ((common * dt[..., None]).sum((0, 1)), common.sum((0, 1)), phi_abs.t() @ g_abs,
                 g_abs.sum(0))
        torch.cuda.synchronize()
        err, rel = grad_errors(got, want, terms)
        if not rel <= GRAD_RTOL:
            raise AssertionError(f"time_channel_bwd@{config}: error {rel} of sum|terms| > {GRAD_RTOL}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"time_channel_bwd@{config}: a second launch differs")
        del theta, mask, phi_abs, common, got, again, want
        n_valid = int(valid.sum())
        # split TF32 on the tensor cores: three passes of the dW and dPhi
        # products; a cosine and a sine per valid (position, feature), at
        # the SFU's rate
        record(
            ("time_channel_bwd", config), f"M{m} L{lp} patch{patch}", err, rel,
            cuda_ms(lambda: ops.time_channel_backward(*args), iters),
            cuda_ms(lambda: ops.time_channel_backward_plain(*args), max(2, iters // 5)),
            None,
            4 * m * lp + m * lp + 4 * (2 * DT_DIM + k * CED + rows * CED)
            + 4 * (k * CED + CED + 2 * DT_DIM),
            SPLIT_TF32_PASSES * 4 * rows * k * CED, PEAK_TF32_OPS, sfu=2 * n_valid * DT_DIM,
        )
        del dt, valid, dout, args
        torch.cuda.empty_cache()

        # ---- patch projection backward: gathered 172-wide rows, pads zero
        x = torch.randn((m, lp, FEAT), device=dev, generator=gen)
        x[:, lp // 2 :, :] = 0.0
        k = patch * FEAT
        dout = 1e-3 * torch.randn((m, lp // patch, CED), device=dev, generator=gen)
        got = ops.patch_projection_backward(x, dout, patch)
        again = ops.patch_projection_backward(x, dout, patch)
        want = ops.patch_projection_backward_plain(x, dout, patch)
        x2, g2 = x.view(rows, k), dout.view(rows, CED)
        terms = (x2.abs().t() @ g2.abs(), g2.abs().sum(0))
        torch.cuda.synchronize()
        err, rel = grad_errors(got, want, terms)
        if not rel <= GRAD_RTOL:
            raise AssertionError(
                f"patch_projection_bwd@{config}: error {rel} of sum|terms| > {GRAD_RTOL}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"patch_projection_bwd@{config}: a second launch differs")
        del got, again, want, terms
        record(
            ("patch_projection_bwd", config), f"M{m} Lp{lp} D{FEAT} patch{patch}", err, rel,
            cuda_ms(lambda: ops.patch_projection_backward(x, dout, patch), iters),
            cuda_ms(lambda: ops.patch_projection_backward_plain(x, dout, patch), iters),
            cuda_ms(lambda: torch.mm(x2.t(), g2), iters),
            4 * (m * lp * FEAT + rows * CED + (k + 1) * CED),
            SPLIT_TF32_PASSES * 2 * rows * (k + 1) * CED, PEAK_TF32_OPS,
        )
        del x, x2, g2, dout
        torch.cuda.empty_cache()

        # ---- entry-window fetch from a table of the full stream's size
        # (2 x 157474 entries, 344-wide rows, guard pads of maxlen rows)
        pad, entries, nodes = max(512, lp), 2 * 157474, 9229
        table = torch.randn((2 * pad + entries + nodes + 16, 2 * FEAT), device=dev, generator=gen)
        table[:pad] = 0.0
        table[pad + entries : 2 * pad + entries] = 0.0
        counts = torch.randint(0, lp, (m,), device=dev, generator=gen, dtype=torch.int32)
        starts = pad + torch.randint(0, entries - lp, (m,), device=dev, generator=gen,
                                     dtype=torch.int32)
        tgts = 2 * pad + entries + torch.randint(0, nodes, (m,), device=dev, generator=gen,
                                                 dtype=torch.int32)
        args = (table, tgts, starts, counts, lp, FEAT)
        node, edge = ops.fetch_sequence_features(*args)
        ref_node, ref_edge = ops.fetch_sequence_features_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(node, ref_node) and torch.equal(edge, ref_edge)):
            raise AssertionError(f"window_fetch@{config}: not bitwise equal to the plain version")
        err = max((node - ref_node).abs().max().item(), (edge - ref_edge).abs().max().item())
        del node, edge, ref_node, ref_edge
        from dyglib_tpu_torch.ops.window_fetch import window_rows

        idx = window_rows(tgts, starts, counts, lp).view(-1)
        rows_read = m + int(counts.sum())
        record(
            ("window_fetch", config), f"M{m} L{lp} W{2 * FEAT}", err, 0.0,
            cuda_ms(lambda: ops.fetch_sequence_features(*args), iters),
            cuda_ms(lambda: ops.fetch_sequence_features_plain(*args), iters),
            cuda_ms(lambda: table.index_select(0, idx), iters),
            4 * (m * lp * 2 * FEAT + rows_read * 2 * FEAT) + 12 * m,
            0,
        )
        del table, idx, args
        torch.cuda.empty_cache()
    return results


def tgat_batch(data, dev):
    """TGAT at its published widths (weights from seed 0, on the card) and
    the hop tensors of the first val batch's triple, sampled from the full
    stream's CSR with its entry table: (net, tables, csr, inputs)."""
    import numpy as np
    import torch

    from dyglib_tpu_torch.graph import build_temporal_csr
    from dyglib_tpu_torch.graph.csr import time_keys
    from dyglib_tpu_torch.models import TGAT, FeatureTables

    tgat = TGAT(num_neighbors=TGAT_K, num_layers=2, num_heads=2, time_feat_dim=DT_DIM,
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
    return net, tables, csr, inputs


def check_tgat_kernels(data, dev) -> dict:
    """Phase 3, TGAT's four attention kernels, at the shapes TGAT's
    evaluation gives them (the B = 200 triple: M0 = 600 queries, K = 20):
    temporal attention at layer 2 (M = 600), gathered and window attention
    at layer 1, hop 1 (M = 12,000, 240,000 kv rows; window attention reads
    the stream's feat_entry), the Phi projection at R = 12,000 and
    240,000. Inputs are the sampled batch's (features, time deltas, masks,
    windows) and the seed-0 weights. Each attention forward and the Phi
    projection launched twice must give bitwise equal outputs. The library yardstick is partial: the plain path's two
    K/V torch.mm's on the materialized kv (for the Phi projection, torch.mm
    on a precomputed Phi), timed alone."""
    import torch

    from dyglib_tpu_torch import ops

    net, tables, csr, inputs = tgat_batch(data, dev)
    conv = net.temporal_conv_0
    heads, k = conv.num_heads, TGAT_K
    tw, tb = net.time_encoder.w.detach().reshape(-1), net.time_encoder.b.detach()
    wk, wv = conv.key_projection.weight.detach().t(), conv.value_projection.weight.detach().t()
    kv_dim, dq = wk.shape
    results = {}

    def hop(h):
        """Layer-1 operands of hop h: q3, dt, mask, keep."""
        ids = inputs.hop_ids[h].reshape(-1).long()
        m = ids.shape[0]
        dt = (inputs.hop_ts[h].reshape(-1, 1) - inputs.hop_ts[h + 1].reshape(m, k)).float()
        phi0 = net.time_encoder(torch.zeros((m, 1), device=dev))[:, 0, :]
        q3 = conv.query_projection(torch.cat([tables.node[ids], phi0], dim=-1))
        mask = inputs.hop_mask[h].reshape(m, k).float()
        return q3.contiguous(), dt, mask, torch.ones((m, heads, k), device=dev)

    def record(kernel, part, err, fn, plain, lib, nbytes, nops, iters, ops_peak=PEAK_F32_OPS,
               sfu=0):
        entry = dict(part=part, max_abs_err=err, ms=cuda_ms(fn, iters, 3),
                     plain_ms=cuda_ms(plain, iters, 3), library_ms=cuda_ms(lib, iters, 3),
                     bytes=nbytes, ops=nops, ops_peak=ops_peak, sfu_ops=sfu)
        results.setdefault((kernel, "tgat"), {"parts": []})["parts"].append(entry)
        what = "Phi @ W mm" if kernel == "phi_projection" else "K/V mm's"
        b_ms, b_by = bound_ms(nbytes, nops, ops_peak)
        log(f"  {kernel:<20} {part:<26} err {err:.3g}  kernel {entry['ms']:.4f} ms  "
            f"plain {entry['plain_ms']:.4f} ms  library (partial: {what}) "
            f"{entry['library_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})")

    def compare(kernel, fn, plain, repeat=False):
        """Hold the kernel's outputs to the plain version's; with repeat, a
        second launch must be bitwise equal to the first."""
        def outputs(f):
            out = f()
            return out if isinstance(out, tuple) else (out,)

        got = outputs(fn)
        again = outputs(fn) if repeat else got
        want = outputs(plain)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{kernel}@tgat: two launches differ")
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if not (all(g.shape == w.shape for g, w in zip(got, want)) and err <= KERNEL_ATOL):
            raise AssertionError(f"{kernel}@tgat: max abs err {err} > {KERNEL_ATOL}")
        return err

    with torch.inference_mode():
        # the operations the function needs, which the kernels compute
        # (reassociated: no kv row projected): qk = Wk_h q3_h and out_h =
        # Av_h Wv_h (2 dq kv_dim each a query), the logits and Av = sum_j w
        # kv_j (2 kv_dim each per (query, head, neighbor)), ~6 for the mask,
        # softmax and keep
        fwd_ops = lambda m: 4 * m * dq * kv_dim + 4 * m * heads * k * kv_dim + 6 * m * heads * k
        small = lambda m: 4 * (2 * m * dq + 2 * m * k + m * heads * k + 2 * kv_dim * dq)

        # ---- temporal attention, layer 2 (M = 600): kv = [layer-1
        # embeddings || edge rows || Phi(dt)]
        q3, dt, mask, keep = hop(0)
        m = q3.shape[0]
        nbr = torch.randn((m, k, FEAT), device=dev, generator=torch.Generator(device=dev).manual_seed(5))
        edge = tables.edge[inputs.hop_eids[0].reshape(m, k).long()]
        phi = net.time_encoder(dt)
        args = (q3, nbr, edge, phi, mask, keep, wk, wv, heads)
        err = compare("temporal_attention", lambda: ops.temporal_attention(*args),
                      lambda: ops.temporal_attention_plain(*args), repeat=True)
        kv = torch.cat([nbr, edge, phi], dim=-1).reshape(m * k, kv_dim)
        record("temporal_attention", f"M{m} K{k} Dkv{kv_dim} Dq{dq}", err,
               lambda: ops.temporal_attention(*args), lambda: ops.temporal_attention_plain(*args),
               lambda: (torch.mm(kv, wk), torch.mm(kv, wv)), small(m) + 4 * m * k * kv_dim,
               fwd_ops(m), 50)
        del nbr, edge, phi, kv, args

        # ---- gathered and window attention, layer 1, hop 1 (M = 12,000)
        q3, dt, mask, keep = hop(1)
        m = q3.shape[0]
        feat_n = tables.node[inputs.hop_ids[2].reshape(-1).long()]
        feat_e = tables.edge[inputs.hop_eids[1].reshape(-1).long()]
        args = (q3, feat_n, feat_e, dt, mask, keep, (tw, tb), (wk, wv), heads)
        err = compare("gathered_attention", lambda: ops.gathered_attention(*args),
                      lambda: ops.gathered_attention_plain(*args), repeat=True)
        kv = torch.cat([feat_n, feat_e, torch.cos(dt.reshape(-1, 1) * tw + tb)], dim=-1)
        lib = lambda: (torch.mm(kv, wk), torch.mm(kv, wv))
        theta_ops = 2 * m * k * DT_DIM  # Phi's argument; the cosines uncounted
        nbytes = small(m) + 4 * (m * k * 2 * FEAT + 2 * DT_DIM)
        record("gathered_attention", f"M{m} K{k} Dkv{kv_dim} Dq{dq}", err,
               lambda: ops.gathered_attention(*args), lambda: ops.gathered_attention_plain(*args),
               lib, nbytes, fwd_ops(m) + theta_ops, 5)

        starts = inputs.hop_win_start[1].reshape(-1)
        args = (q3, starts, dt, mask, keep, csr.feat_entry, tw, tb, (wk, wv), heads)
        err = compare("window_attention", lambda: ops.window_attention(*args),
                      lambda: ops.window_attention_plain(*args), repeat=True)
        # the table rows this run needs: the valid window rows (the others
        # are multiplied by a zero mask)
        n_valid = int(mask.sum())
        nbytes = small(m) + 4 * (n_valid * 2 * FEAT + 2 * DT_DIM) + 4 * m
        record("window_attention", f"M{m} K{k} W{2 * FEAT} valid rows {n_valid}", err,
               lambda: ops.window_attention(*args), lambda: ops.window_attention_plain(*args),
               lib, nbytes, fwd_ops(m) + theta_ops + m * k * 2 * FEAT, 5)
        del feat_n, feat_e, kv, args

        # ---- Phi projection, R = 12,000 and 240,000 (hop 0's and hop 1's
        # deltas), Wk's Phi rows; its products on the tensor cores in three
        # TF32 passes, its cosines at the SFU's rate
        for h in (0, 1):
            dt_flat, w_phi = hop(h)[1].reshape(-1), wk[2 * FEAT:]
            r = dt_flat.shape[0]
            args = (dt_flat, tw, tb, w_phi)
            err = compare("phi_projection", lambda: ops.phi_projection(*args),
                          lambda: ops.phi_projection_plain(*args), repeat=True)
            phi = torch.cos(dt_flat[:, None] * tw + tb)
            record("phi_projection", f"R{r} Dt{DT_DIM} Dq{dq}", err,
                   lambda: ops.phi_projection(*args), lambda: ops.phi_projection_plain(*args),
                   lambda: torch.mm(phi, w_phi), 4 * (r + 2 * DT_DIM + DT_DIM * dq + r * dq),
                   SPLIT_TF32_PASSES * 2 * r * DT_DIM * dq, 10 if h else 50,
                   ops_peak=PEAK_TF32_OPS, sfu=r * DT_DIM)
            del phi, args
    del net, tables, csr, inputs
    torch.cuda.empty_cache()
    return results


def check_tgat_backward_kernels(data, dev) -> dict:
    """Phase 3, TGAT's four backward kernels at the shapes TGAT's training
    gives them (the B = 200 triple, K = 20, dropout keep masks at p = 0.1):
    temporal attention at layer 2 (M = 600), gathered and window attention
    at layer 1 on hop 0 (M = 600) and hop 1 (M = 12,000, 240,000 kv rows),
    the Phi projection at R = 12,000 and 240,000. Each against its plain
    backward (every gradient within GRAD_RTOL of its sum of |terms|), a
    second launch bitwise equal to the first. The library yardstick is partial: the two
    weight-gradient torch.mm's on the materialized kv and dkey / dval (for
    the Phi projection, Phi^T @ dout and dout @ w^T on a precomputed Phi),
    timed alone; the port never calls them. Bounds count the operations
    the function needs, reassociated as the kernels compute it."""
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.ops import _attention

    net, tables, csr, inputs = tgat_batch(data, dev)
    conv = net.temporal_conv_0
    heads, k = conv.num_heads, TGAT_K
    tw, tb = net.time_encoder.w.detach().reshape(-1), net.time_encoder.b.detach()
    wk, wv = conv.key_projection.weight.detach().t(), conv.value_projection.weight.detach().t()
    kv_dim, dq = wk.shape
    gen = torch.Generator(device=dev).manual_seed(77)
    results = {}

    def hop(h):
        """Layer-1 operands of hop h: q3, dt, mask, a p = 0.1 keep mask and
        an output cotangent."""
        ids = inputs.hop_ids[h].reshape(-1).long()
        m = ids.shape[0]
        dt = (inputs.hop_ts[h].reshape(-1, 1) - inputs.hop_ts[h + 1].reshape(m, k)).float()
        phi0 = net.time_encoder(torch.zeros((m, 1), device=dev))[:, 0, :]
        q3 = conv.query_projection(torch.cat([tables.node[ids], phi0], dim=-1))
        mask = inputs.hop_mask[h].reshape(m, k).float()
        keep = (torch.rand((m, heads, k), device=dev, generator=gen) < 1 - TGAT_DROPOUT) / (
            1 - TGAT_DROPOUT)
        dout = 1e-3 * torch.randn((m, dq), device=dev, generator=gen)
        return q3.detach().contiguous(), dt, mask, keep, dout

    def check(kernel, part, bwd, plain, args, lib, nbytes, nops, iters, ops_peak=PEAK_F32_OPS,
              sfu=0):
        """Hold the backward kernel to its plain backward, time the three."""
        got = bwd(*args)
        again = bwd(*args)
        want = plain(*args)
        terms = plain(*args, abs_terms=True)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{kernel}@tgat {part}: two launches differ")
        if not all(torch.isfinite(a).all() for a in got):
            raise AssertionError(f"{kernel}@tgat {part}: a gradient is not finite")
        err, rel = grad_errors(got, want, terms)
        if not rel <= GRAD_RTOL:
            raise AssertionError(f"{kernel}@tgat {part}: error {rel} of sum|terms| > {GRAD_RTOL}")
        del got, again, want, terms
        entry = dict(part=part, max_abs_err=err, ms=cuda_ms(lambda: bwd(*args), iters, 3),
                     plain_ms=cuda_ms(lambda: plain(*args), iters, 3),
                     library_ms=cuda_ms(lib, iters, 3), bytes=nbytes, ops=nops,
                     ops_peak=ops_peak, sfu_ops=sfu)
        results.setdefault((kernel, "tgat"), {"parts": []})["parts"].append(entry)
        b_ms, b_by = bound_ms(nbytes, nops, ops_peak)
        log(f"  {kernel:<24} {part:<24} err {err:.3g} ({rel:.3g} of sum|terms|)  kernel "
            f"{entry['ms']:.4f} ms  plain {entry['plain_ms']:.4f} ms  library (partial: weight "
            f"gradient mm's) {entry['library_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})")

    def weight_grad_mms(kv, q3, mask, keep, dout, wkv):
        """The partial yardstick's operands: kv (R, Dkv), dkey, dval (R, Dq)."""
        m = q3.shape[0]
        key, val = _attention.project_kv(kv, *wkv)
        _, dkey, dval = _attention.attend_backward(
            q3, key.view(m, k, -1), val.view(m, k, -1), mask, keep, dout, None, heads)
        dkey, dval = dkey.reshape(m * k, dq), dval.reshape(m * k, dq)
        return lambda: (torch.mm(kv.t(), dkey), torch.mm(kv.t(), dval))

    # operations of the reassociated backward: qk, gv, dq3, dWk, dWv (10 dq
    # kv_dim a query); logits, ds_d, Ak, Av (8 kv_dim per (query, head,
    # neighbor)); dkv's needed columns (4 each); ~12 for the softmax's
    # backward; Phi's argument (2) and -sin * dPhi, dtb, dtw (5) per kv row
    # and Phi column where dtw and dtb are returned
    def bwd_ops(m, kv_cols, phi_cols=0):
        return (10 * m * dq * kv_dim + 8 * m * heads * k * kv_dim
                + 4 * m * heads * k * kv_cols + 12 * m * heads * k + 7 * m * k * phi_cols)

    small = lambda m: 4 * (3 * m * dq + 2 * m * k + m * heads * k + 4 * kv_dim * dq)

    with torch.no_grad():
        # ---- temporal attention, layer 2 (M = 600), no scores cotangent
        q3, dt, mask, keep, dout = hop(0)
        m = q3.shape[0]
        nbr = torch.randn((m, k, FEAT), device=dev, generator=gen)
        edge = tables.edge[inputs.hop_eids[0].reshape(m, k).long()]
        phi = net.time_encoder(dt)
        args = (q3, nbr, edge, phi, mask, keep, wk, wv, dout, None, heads)
        kv = torch.cat([nbr, edge, phi], dim=-1).reshape(m * k, kv_dim)
        check("temporal_attention_bwd", f"M{m} K{k} Dkv{kv_dim} Dq{dq}",
              ops.temporal_attention_backward, ops.temporal_attention_backward_plain, args,
              weight_grad_mms(kv, q3, mask, keep, dout, (wk, wv)),
              small(m) + 2 * 4 * m * k * kv_dim, bwd_ops(m, kv_dim), 20)
        del nbr, edge, phi, kv, args

        # ---- gathered and window attention, layer 1, hops 0 and 1
        for h in (0, 1):
            q3, dt, mask, keep, dout = hop(h)
            m = q3.shape[0]
            feat_n = tables.node[inputs.hop_ids[h + 1].reshape(-1).long()]
            feat_e = tables.edge[inputs.hop_eids[h].reshape(-1).long()]
            kv = torch.cat([feat_n, feat_e, torch.cos(dt.reshape(-1, 1) * tw + tb)], dim=-1)
            lib = weight_grad_mms(kv, q3, mask, keep, dout, (wk, wv))
            iters = 20 if m < 1000 else 3
            part = f"M{m} K{k} Dkv{kv_dim} Dq{dq}"
            args = (q3, feat_n, feat_e, dt, mask, keep, (tw, tb), (wk, wv), dout, heads)
            check("gathered_attention_bwd", part, ops.gathered_attention_backward,
                  ops.gathered_attention_backward_plain, args, lib,
                  small(m) + 4 * (m * k * (2 * FEAT + 1) + 4 * DT_DIM),
                  bwd_ops(m, DT_DIM, DT_DIM), iters)
            starts = inputs.hop_win_start[h].reshape(-1)
            n_valid = int(mask.sum())
            args = (q3, starts, dt, mask, keep, csr.feat_entry, tw, tb, (wk, wv), dout, heads)
            check("window_attention_bwd", f"{part} valid rows {n_valid}",
                  ops.window_attention_backward, ops.window_attention_backward_plain, args, lib,
                  small(m) + 4 * (n_valid * 2 * FEAT + m * k + 4 * DT_DIM + m),
                  bwd_ops(m, DT_DIM, DT_DIM) + m * k * 2 * FEAT, iters)
            del feat_n, feat_e, kv, lib, args
            torch.cuda.empty_cache()

        # ---- Phi projection, R = 12,000 and 240,000 (hop 0's and hop 1's
        # deltas), Wk's Phi rows; both products on the tensor cores in three
        # TF32 passes, a (cosine, sine) pair per element at the SFU's rate
        for h in (0, 1):
            dt_flat, w_phi = hop(h)[1].reshape(-1), wk[2 * FEAT:]
            r = dt_flat.shape[0]
            dout = 1e-3 * torch.randn((r, dq), device=dev, generator=gen)
            phi = torch.cos(dt_flat[:, None] * tw + tb)
            check("phi_projection_bwd", f"R{r} Dt{DT_DIM} Dq{dq}", ops.phi_projection_backward,
                  ops.phi_projection_backward_plain, (dt_flat, tw, tb, w_phi, dout),
                  lambda: (torch.mm(phi.t(), dout), torch.mm(dout, w_phi.t())),
                  4 * (r + 4 * DT_DIM + 2 * DT_DIM * dq + r * dq),
                  SPLIT_TF32_PASSES * 4 * r * DT_DIM * dq, 10 if h else 50,
                  ops_peak=PEAK_TF32_OPS, sfu=2 * r * DT_DIM)
            del dout, phi
    del net, tables, csr, inputs
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
    missing = [k for k in EVAL_KERNELS if launches[k] == 0]
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


def run_tgat(data, n_batches, dev) -> dict:
    """The TGAT evaluation phase: four configurations of one set of seed-0
    weights, each evaluated on the first n_batches val batches, in turns
    (each once forward, then once in reverse order)."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.data import chronological_batches
    from dyglib_tpu_torch.models import TGAT
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    trainers, params = {}, None
    for name, (kw, use_kernels, _) in TGAT_CONFIGS.items():
        backbone = TGAT(num_neighbors=TGAT_K, num_layers=2, num_heads=2, time_feat_dim=DT_DIM,
                        **kw)
        tr = LinkPredictionTrainer(backbone, data, TrainConfig(batch_size=B), device=dev)
        if (tr.full_csr.feat_entry is not None) != (name == "window"):
            raise AssertionError(f"TGAT {name}: the entry table is built iff the window path runs")
        if params is None:
            tr.init_params(0)
            params = tr.state_dicts()
        else:
            tr.load_params(params)
        tr.model.use_kernels = use_kernels
        tr.evaluate(data.val.slice(0, B), tr.val_neg)  # warm-up: allocator, cuBLAS
        trainers[name] = tr
    stream = data.val.slice(0, n_batches * B)
    torch.cuda.synchronize()

    launches, ms, probs_of, diffs, metrics_of = {}, {n: [] for n in TGAT_CONFIGS}, {}, {}, {}
    for name in list(TGAT_CONFIGS) + list(reversed(TGAT_CONFIGS)):
        tr = trainers[name]
        ops.reset_launch_counts()  # just before the sweep
        t0 = time.perf_counter()
        losses, metrics, probs = tr.evaluate(stream, tr.val_neg)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) / n_batches * 1e3)
        counts = ops.launch_counts()  # just after
        want = TGAT_CONFIGS[name][2]
        if {k for k, v in counts.items() if v} != set(want) or any(
            counts[k] != per_batch * n_batches for k, per_batch in want.items()
        ):
            raise AssertionError(f"TGAT {name}: launched {counts}, expected {want} per batch")
        launches[name] = {k: v for k, v in counts.items() if v}
        if len(probs) != n_batches or not all(
            pos.shape == neg.shape == (B,) and np.isfinite(pos).all() and np.isfinite(neg).all()
            for pos, neg in probs
        ):
            raise AssertionError(f"TGAT {name}: probabilities malformed or not finite")
        mean = tr.mean_metrics(metrics)
        if not all(0.0 <= v <= 1.0 for v in mean.values()) or not np.isfinite(losses).all():
            raise AssertionError(f"TGAT {name}: metrics out of range {mean}")
        metrics_of[name] = mean
        if "plain" not in probs_of:
            probs_of["plain"] = probs  # the first sweep is the plain one
        diffs[name] = max(diffs.get(name, 0.0), max_prob_diff(probs, probs_of["plain"]))
        if not diffs[name] <= PROB_ATOL:
            raise AssertionError(f"TGAT {name} vs plain: probabilities differ by {diffs[name]}")
        probs_of.setdefault(name, probs)

    # one batch's embeddings through each configuration's kernels vs its
    # plain versions (the probabilities can round a small difference away)
    emb_diffs = {}
    with torch.inference_mode():
        for name, tr in trainers.items():
            if not TGAT_CONFIGS[name][1]:
                continue
            b = next(iter(chronological_batches(stream, B)))
            ns, nd = tr._pad_negs(b.src, b), tr._pad_negs(np.roll(b.dst, 1), b)
            src, dst, _, neg_dst, ts, _, _ = tr._batch_arrays(b, ns, nd)
            inputs = tr._sample(tr.full_csr, src, dst, neg_dst, ts, None)
            emb_kernel = tr._embed(inputs)
            tr.model.use_kernels = False
            emb_plain = tr._embed(inputs)
            tr.model.use_kernels = True
            emb_diffs[name] = (emb_kernel - emb_plain).abs().max().item()
            if not emb_diffs[name] <= KERNEL_ATOL:
                raise AssertionError(f"TGAT {name}: kernel vs plain embeddings differ by "
                                     f"{emb_diffs[name]}")

    # the first batches on the port's CPU path, default configuration
    n_cpu = 2
    cpu = LinkPredictionTrainer(TGAT(num_neighbors=TGAT_K, time_feat_dim=DT_DIM), data,
                                TrainConfig(batch_size=B), device="cpu")
    cpu.load_params({part: {k: v.cpu() for k, v in sd.items()} for part, sd in params.items()})
    _, _, cpu_probs = cpu.evaluate(data.val.slice(0, n_cpu * B), cpu.val_neg)
    cpu_diff = max_prob_diff(probs_of["default"][:n_cpu], cpu_probs)
    if not cpu_diff <= PROB_ATOL:
        raise AssertionError(f"TGAT: card vs CPU probabilities differ by {cpu_diff}")
    result = dict(
        batches=n_batches, launches=launches, ms_per_batch=ms, metrics=metrics_of,
        max_prob_diff_vs_plain=diffs, max_embedding_diff_vs_plain=emb_diffs,
        max_prob_diff_vs_cpu=cpu_diff,
    )
    log(f"  {json.dumps(result)}")
    return result


def tgat_trainers(data, dev, dropout=0.0, **extra):
    """One TGAT trainer per configuration of TGAT_CONFIGS, at the published
    widths, all holding the same seed-0 weights; returns (trainers, the
    weights' state dicts)."""
    from dyglib_tpu_torch.models import TGAT
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    trainers, params = {}, None
    for name, (kw, use_kernels, _) in TGAT_CONFIGS.items():
        backbone = TGAT(num_neighbors=TGAT_K, num_layers=2, num_heads=2, time_feat_dim=DT_DIM,
                        dropout=dropout, **kw, **extra)
        tr = LinkPredictionTrainer(
            backbone, data, TrainConfig(batch_size=B, learning_rate=TRAIN_LR), device=dev)
        if params is None:
            tr.init_params(0)
            # a copy: the state dicts share the live weights, which training moves
            params = {part: {n: v.clone() for n, v in sd.items()}
                      for part, sd in tr.state_dicts().items()}
        else:
            tr.load_params(params)
        tr.model.use_kernels = use_kernels
        trainers[name] = tr
    return trainers, params


def kernel_side(out, k):
    """The plain path's ReLU inputs ``out`` with every entry whose sign
    differs from the kernel path's ``k`` replaced by k's value, the
    gradient with respect to ``out`` still the identity
    (``k + (out - out.detach())``, exactly k's value): both paths then take
    the same branch of the ReLU and pass the same cotangent back. Returns (the inputs, or None
    where nothing changed sign; how many changed sign; the largest |input|
    among them on either path)."""
    import torch

    flipped = (out > 0) != (k > 0)
    n = int(flipped.sum())
    if n == 0:
        return None, 0, 0.0
    worst = max(float(out.detach()[flipped].abs().max()), float(k[flipped].abs().max()))
    return torch.where(flipped, k + (out - out.detach()), out), n, worst


def tgat_lockstep(tr, params, batches, dropout: float, align: bool = True) -> dict:
    """TGAT's train steps in lockstep: at every step both paths' loss and
    gradients from the same parameters (the kernel path's trajectory), the
    dropout generator reseeded the same way for both, then the kernel
    path's optimizer step. Returns the largest loss difference
    (``loss_diff``), the largest gradient error as a share of its tensor's
    largest entry (``grad_err``; the time encoder's frequencies left to
    phase 3's sum-of-|terms| check), the tensor where it fell (``worst``),
    and for each ReLU of the network (the merge layers' and the link
    head's ``fc1`` outputs) how many inputs took another sign on the two
    paths, with the largest |input| among them
    (``largest_flipped_input``).

    Such an input lies within rounding of zero (the kernels sum in another
    order than cuBLAS), and its two subgradients are both right; but it
    moves its row's whole share of the later layers' gradients, so the two
    paths' gradients would differ far above rounding through no fault of a
    kernel (ROADMAP Queue 3, item 3). With ``align`` the plain path takes
    the kernel path's value there (``kernel_side``): the gradients
    compared are those of the same branch. check_tgat_lockstep requires
    each such input within FLIP_ATOL of zero."""
    import torch

    tr.backbone.dropout = dropout
    tr.init_params(0)
    tr.load_params(params)
    tr.model.train()
    tr.head.train()
    named = [*(("backbone." + k, p) for k, p in tr.model.named_parameters()),
             *(("head." + k, p) for k, p in tr.head.named_parameters())]
    weights = [p for _, p in named]
    relus = {f"merge_{l}.fc1": getattr(tr.model, f"merge_{l}").fc1
             for l in range(tr.backbone.num_layers)}
    relus["head.fc1"] = tr.head.fc1
    kernel_acts = {r: [] for r in relus}  # the kernel pass's ReLU inputs, call by call
    calls = {r: 0 for r in relus}
    path = [True]
    flips = {r: 0 for r in relus}
    flip_max = [0.0]

    def hook(r):
        def on_output(mod, inputs, out):
            if path[0]:
                kernel_acts[r].append(out.detach())
                return None
            aligned, n, worst = kernel_side(out, kernel_acts[r][calls[r]])
            calls[r] += 1
            flips[r] += n
            flip_max[0] = max(flip_max[0], worst)
            return aligned if align else None
        return on_output

    hooks = [mod.register_forward_hook(hook(r)) for r, mod in relus.items()]
    loss_diff, grad_err, worst = 0.0, 0.0, ""
    try:
        for step, (arrays, bucket) in enumerate(batches):
            src, dst, _, neg_dst, ts, _, valid = arrays
            out = {}
            for use_kernels in (True, False):
                path[0] = use_kernels
                if use_kernels:
                    for r in relus:
                        kernel_acts[r], calls[r] = [], 0
                tr.model.use_kernels = use_kernels
                tr.dropout_gen.manual_seed(1000 + step)
                inputs = tr._sample(tr.train_csr, src, dst, neg_dst, ts, bucket)
                loss, _ = tr._head_loss(tr._embed(inputs, tr.dropout_gen), valid)
                out[use_kernels] = (float(loss.detach()), torch.autograd.grad(loss, weights))
            loss_diff = max(loss_diff, abs(out[True][0] - out[False][0]))
            top = max(float(g.abs().max()) for g in out[False][1])
            for (pname, _), gk, gp in zip(named, out[True][1], out[False][1]):
                if not torch.isfinite(gk).all():
                    raise AssertionError(f"TGAT lockstep: {pname}'s gradient is not finite")
                if pname == "backbone.time_encoder.w":
                    continue
                scale = max(float(gp.abs().max()), 1e-3 * top)  # zero-in-theory tensors
                err = float((gk - gp).abs().max()) / scale
                if err > grad_err:
                    grad_err, worst = err, f"{pname} at step {step}"
            for p, g in zip(weights, out[True][1]):
                p.grad = g
            tr.optimizer.step()
    finally:
        for h in hooks:
            h.remove()
    tr.model.use_kernels = True
    tr.backbone.dropout = 0.0
    return dict(loss_diff=loss_diff, grad_err=grad_err, worst=worst, flips=flips,
                largest_flipped_input=flip_max[0])


def check_tgat_lockstep(stats: dict, name: str, dropout: float) -> dict:
    """Raise unless a lockstep (tgat_lockstep) held: losses within
    LOSS_ATOL, gradients within GRAD_STEP_RTOL, and every ReLU input that
    changed sign within FLIP_ATOL of zero (else the forwards differ by more
    than rounding). Returns the stats."""
    if stats["largest_flipped_input"] > FLIP_ATOL:
        raise AssertionError(f"TGAT {name} lockstep: a ReLU input "
                             f"{stats['largest_flipped_input']} from zero changed sign between "
                             f"the paths (limit {FLIP_ATOL}; {stats['flips']})")
    if not (stats["loss_diff"] <= LOSS_ATOL and stats["grad_err"] <= GRAD_STEP_RTOL):
        raise AssertionError(f"TGAT {name} training in lockstep (dropout {dropout}): losses "
                             f"differ by {stats['loss_diff']}, gradients by "
                             f"{stats['grad_err']} of their largest entries ({stats['worst']}); "
                             f"ReLU inputs that changed sign: {stats['flips']}")
    return stats


def tgat_train_batches(data, tr) -> list:
    """The last TGAT_TRAIN_STEPS train batches, negatives from a seeded
    sampler set on ``tr``: [(arrays, bucket)]."""
    from dyglib_tpu_torch.graph import NegativeEdgeSampler

    tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=13)
    n = data.train.num_interactions
    stream = data.train.slice(n - TGAT_TRAIN_STEPS * B, n)
    return [(arrays, bucket) for _, arrays, bucket in tr.train_batches(stream)]


def run_tgat_training(data, dev) -> dict:
    """Phase 5t: TGAT's train step in four configurations, in turns."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops

    trainers, params = tgat_trainers(data, dev)
    batches = tgat_train_batches(data, trainers["plain"])

    def sweep(name, steps=batches):
        """The steps from the seed-0 weights; returns launch counts, ms per
        step, losses and whether every gradient was finite."""
        tr = trainers[name]
        tr.load_params(params)
        tr.optimizer = type(tr.optimizer)(
            list(tr.model.parameters()) + list(tr.head.parameters()), lr=TRAIN_LR)
        torch.cuda.synchronize()
        ops.reset_launch_counts()  # just before the sweep
        t0 = time.perf_counter()
        losses = [tr.train_step(arrays, bucket)[0] for arrays, bucket in steps]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / len(steps) * 1e3
        counts = ops.launch_counts()  # just after
        finite = all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                     for mod in (tr.model, tr.head) for p in mod.parameters())
        return counts, ms, [float(x) for x in losses], finite

    for name in TGAT_CONFIGS:  # warm-up: allocator, cuBLAS
        sweep(name, batches[:1])
    launches, ms, losses_of = {}, {name: [] for name in TGAT_CONFIGS}, {}
    for name in list(TGAT_CONFIGS) + list(reversed(TGAT_CONFIGS)):
        counts, step_ms, losses, finite = sweep(name)
        per_step = TGAT_CONFIGS[name][2]
        want = {**per_step, **{f"{k}_bwd": v for k, v in per_step.items()}}
        got = {k: v for k, v in counts.items() if v}
        if got != {k: v * len(batches) for k, v in want.items()}:
            raise AssertionError(f"TGAT {name} training: launched {got}, expected {want} a step")
        if not finite or not np.isfinite(losses).all():
            raise AssertionError(f"TGAT {name} training: a gradient or loss is not finite")
        launches.setdefault(name, got)
        ms[name].append(step_ms)
        losses_of.setdefault(name, losses)
    # free-running: the same steps from the same weights; the first loss
    # shares the parameters, the later ones drift (see LOSS_DRIFT_ATOL)
    for name, losses in losses_of.items():
        diffs = [abs(a - b) for a, b in zip(losses, losses_of["plain"])]
        if not (diffs[0] <= LOSS_ATOL and max(diffs) <= LOSS_DRIFT_ATOL):
            raise AssertionError(f"TGAT {name} vs plain training: losses differ by {diffs}")
    steps = {name: check_tgat_lockstep(tgat_lockstep(trainers[name], params, batches, 0.0),
                                       name, 0.0)
             for name in TGAT_CONFIGS if TGAT_CONFIGS[name][1]}
    dropped = {name: check_tgat_lockstep(
                   tgat_lockstep(trainers[name], params, batches[-1:], TGAT_DROPOUT), name,
                   TGAT_DROPOUT)
               for name in TGAT_CONFIGS if TGAT_CONFIGS[name][1]}
    result = dict(
        steps=len(batches), launches=launches, ms_per_step=ms, losses=losses_of,
        lockstep_dropout0=steps, lockstep_dropout01_one_step=dropped,
    )
    del trainers
    torch.cuda.empty_cache()
    log(f"  {json.dumps(result)}")
    return result


def run_tgat_uniform(data, dev, n_steps: int = 3, n_batches: int = 5) -> dict:
    """Phase 5u: TGAT under the uniform strategy (default kernels) trains a
    few steps through its kernels and evaluates the first val batches twice
    with identical probabilities."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.models import TGAT
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    tr = LinkPredictionTrainer(
        TGAT(num_neighbors=TGAT_K, num_layers=2, num_heads=2, time_feat_dim=DT_DIM,
             sample_strategy="uniform"),
        data, TrainConfig(batch_size=B, learning_rate=TRAIN_LR), device=dev)
    tr.init_params(0)
    n = data.train.num_interactions
    batches = list(tr.train_batches(data.train.slice(n - n_steps * B, n)))
    ops.reset_launch_counts()
    losses = [float(tr.train_step(arrays, bucket)[0]) for _, arrays, bucket in batches]
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    want = {"gathered_attention": 2, "gathered_attention_bwd": 2, "temporal_attention": 1,
            "temporal_attention_bwd": 1}
    if counts != {k: v * n_steps for k, v in want.items()} or not np.isfinite(losses).all():
        raise AssertionError(f"TGAT uniform training: launched {counts}, losses {losses}")
    stream = data.val.slice(0, n_batches * B)
    (_, m1, p1), (_, _, p2) = (tr.evaluate(stream, tr.val_neg) for _ in range(2))
    diff = max_prob_diff(p1, p2)
    if diff != 0.0 or len(p1) != n_batches:
        raise AssertionError(f"TGAT uniform: two evaluate sweeps differ by {diff}")
    result = dict(train_losses=losses, train_launches=counts, eval_batches=n_batches,
                  eval_sweep_diff=diff, metrics=tr.mean_metrics(m1))
    log(f"  {json.dumps(result)}")
    return result


def lockstep(tr, backbone, batches, fetch, config) -> tuple[float, float, int]:
    """At every step, both paths' loss and gradients from the same
    parameters (the kernel path's trajectory), then the kernel path's
    optimizer step. Returns the largest loss difference, the largest
    gradient error as a share of its tensor's largest entry, and how many
    of the link head's ReLU inputs (``head.fc1``'s outputs) took another
    sign on the two paths: each such input moves its pair's whole share
    of the head's gradients, so a rounding-level difference there shows
    as a gradient error far above rounding."""
    import torch

    tr.init_params(0)
    backbone.use_entry_fetch = fetch
    named = [*(("backbone." + k, p) for k, p in tr.model.named_parameters()),
             *(("head." + k, p) for k, p in tr.head.named_parameters())]
    params = [p for _, p in named]
    acts: dict[bool, list] = {}
    path = [True]
    hook = tr.head.fc1.register_forward_hook(
        lambda mod, inp, out: acts[path[0]].append(out.detach()))
    loss_diff, grad_err, worst, flips = 0.0, 0.0, "", 0
    try:
        for step, (arrays, bucket) in enumerate(batches):
            src, dst, _, neg_dst, ts, _, valid = arrays
            out = {}
            for use_kernels in (True, False):
                path[0] = use_kernels
                acts[use_kernels] = []
                tr.model.use_kernels = use_kernels
                inputs = tr._sample(tr.train_csr, src, dst, neg_dst, ts, bucket)
                loss, _ = tr._head_loss(tr.model.train()(tr.tables, inputs, triple=True), valid)
                out[use_kernels] = (float(loss.detach()), torch.autograd.grad(loss, params))
            loss_diff = max(loss_diff, abs(out[True][0] - out[False][0]))
            flips += int(((torch.cat(acts[True]) > 0) != (torch.cat(acts[False]) > 0)).sum())
            top = max(float(g.abs().max()) for g in out[False][1])
            for (name, _), gk, gp in zip(named, out[True][1], out[False][1]):
                if name == "backbone.time_encoder.w":
                    continue
                scale = max(float(gp.abs().max()), 1e-3 * top)  # zero-in-theory tensors
                err = float((gk - gp).abs().max()) / scale
                if err > grad_err:
                    grad_err, worst = err, f"{name} at step {step}"
            for p, g in zip(params, out[True][1]):
                p.grad = g
            tr.optimizer.step()
    finally:
        hook.remove()
    if not (loss_diff <= LOSS_ATOL and grad_err <= GRAD_STEP_RTOL):
        raise AssertionError(f"{config} training in lockstep: losses differ by {loss_diff}, "
                             f"gradients by {grad_err} of their largest entries ({worst}); "
                             f"{flips} head ReLU inputs changed sign")
    return loss_diff, grad_err, flips


def run_training(data, config, maxlen, patch, n_steps, dev) -> dict:
    """Phase 5 for one configuration."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.graph import NegativeEdgeSampler
    from dyglib_tpu_torch.models import DyGFormer
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    fetch_main = config == "CanParl"  # the path this configuration drives
    backbone = DyGFormer(
        max_input_sequence_length=maxlen, patch_size=patch, channel_embedding_dim=CED,
        num_layers=2, num_heads=2, time_feat_dim=DT_DIM, dropout=0.0, use_entry_fetch=True,
    )
    tr = LinkPredictionTrainer(
        backbone, data, TrainConfig(batch_size=B, learning_rate=TRAIN_LR), device=dev
    )
    if tr.train_csr.feat_entry is None:
        raise AssertionError(f"{config}: the trainer built no feat_entry table")
    # the last n_steps train batches, negatives from a seeded sampler so
    # that every sweep sees the same batches
    tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=11)
    n = data.train.num_interactions
    stream = data.train.slice(n - n_steps * B, n)
    batches = [(arrays, bucket) for _, arrays, bucket in tr.train_batches(stream)]
    buckets = [bucket or backbone.seq_len for _, bucket in batches]

    def sweep(use_kernels: bool, fetch: bool, steps=batches):
        """n_steps train steps from the seed-0 parameters; returns launch
        counts, ms per step, losses, the final parameters and whether every
        parameter's gradient was finite."""
        tr.init_params(0)
        tr.model.use_kernels = use_kernels
        backbone.use_entry_fetch = fetch
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [tr.train_step(arrays, bucket)[0] for arrays, bucket in steps]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / len(steps) * 1e3
        counts = ops.launch_counts()
        params = [p.detach().clone() for p in tr.model.parameters()]
        finite = all(
            p.grad is not None and bool(torch.isfinite(p.grad).all())
            for mod in (tr.model, tr.head) for p in mod.parameters()
        )
        return counts, ms, [float(x) for x in losses], params, finite

    for use_kernels in (False, True):  # warm-up of both paths: allocator, cuBLAS
        sweep(use_kernels, fetch_main, batches[:1])
    sweep(True, not fetch_main, batches[:1])

    # the main path: counters zeroed just before, read just after
    launches, k_ms, k_losses, k_params, k_finite = sweep(True, fetch_main)
    path_kernels = [*EVAL_KERNELS, "time_channel_bwd", "patch_projection_bwd"] + (
        ["window_fetch"] if fetch_main else [])
    missing = [k for k in path_kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{config} training: kernels never launched: {missing}")
    if not k_finite or not np.isfinite(k_losses).all():
        raise AssertionError(f"{config} training: a gradient or loss is not finite")
    def drift(losses, what):
        """Free-running losses against the first kernel sweep's."""
        diffs = [abs(a - b) for a, b in zip(losses, k_losses)]
        if not (diffs[0] <= LOSS_ATOL and max(diffs) <= LOSS_DRIFT_ATOL):
            raise AssertionError(f"{config} training, {what}: losses differ by {diffs}")
        return max(diffs)

    kernel_ms, plain_ms, loss_diff, param_diff = [k_ms], [], 0.0, 0.0
    for use_kernels in (False, False, True):
        counts, ms, losses, params, finite = sweep(use_kernels, fetch_main)
        if use_kernels and counts != launches:
            raise AssertionError(f"{config}: kernel sweeps launched {counts} vs {launches}")
        if not use_kernels and any(counts.values()):
            raise AssertionError(f"{config}: the plain training path launched a kernel: {counts}")
        if not finite:
            raise AssertionError(f"{config} training: a gradient is not finite")
        (kernel_ms if use_kernels else plain_ms).append(ms)
        loss_diff = max(loss_diff, drift(losses, "kernel vs plain" if not use_kernels else "rerun"))
        param_diff = max(param_diff, max((a - b).abs().max().item()
                                         for a, b in zip(params, k_params)))
    param_atol = 2 * n_steps * TRAIN_LR
    if not param_diff <= param_atol:
        raise AssertionError(
            f"{config} training: kernel vs plain parameters differ by {param_diff} > {param_atol}")
    step_loss_diff, step_grad_err, step_flips = lockstep(tr, backbone, batches, fetch_main,
                                                         config)

    # the other feature fetch, kernels on, in turns with the main one
    other_ms, main_ms, other_launches = [], [], None
    for fetch in (not fetch_main, fetch_main, fetch_main, not fetch_main):
        counts, ms, losses, _, _ = sweep(True, fetch)
        (main_ms if fetch == fetch_main else other_ms).append(ms)
        if fetch != fetch_main:
            other_launches = counts
        drift(losses, "entry fetch vs gather")
    fetch_ms = main_ms if fetch_main else other_ms
    gather_ms = other_ms if fetch_main else main_ms
    window_launches = launches["window_fetch"] if fetch_main else other_launches["window_fetch"]
    if window_launches == 0:
        raise AssertionError(f"{config}: the entry-fetch sweep never launched window_fetch")
    result = dict(
        config=config, maxlen=maxlen, patch=patch, steps=n_steps, buckets=buckets,
        path="entry fetch" if fetch_main else "gather", launches=launches,
        window_fetch_launches=window_launches,
        kernel_ms_per_step=kernel_ms, plain_ms_per_step=plain_ms,
        entry_fetch_ms_per_step=fetch_ms, gather_ms_per_step=gather_ms,
        losses=k_losses, max_loss_drift_vs_plain=loss_diff, max_param_diff_vs_plain=param_diff,
        lockstep_max_loss_diff=step_loss_diff, lockstep_max_grad_err=step_grad_err,
        lockstep_relu_sign_changes=step_flips,
    )
    log(f"  {json.dumps(result)}")
    return result


def run_fit(dev) -> dict:
    """Phase 6: fit on the JAX test fixture, held to the end-metric floors."""
    import numpy as np

    from dyglib_tpu_torch.data import synthetic_link_prediction_data
    from dyglib_tpu_torch.models import DyGFormer
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    data = synthetic_link_prediction_data(
        num_src=120, num_dst=60, num_edges=2000, node_feat_scale=1.0, seed=7
    )
    save_path = os.path.join(REPO_ROOT, "dyglib_tpu_torch", "build", "chip_smoke_fit.pkl")
    tr = LinkPredictionTrainer(
        DyGFormer(max_input_sequence_length=32, patch_size=2, num_layers=2, dropout=0.1),
        data,
        TrainConfig(batch_size=B, num_epochs=4, learning_rate=5e-4, patience=5),
        save_path=save_path, device=dev,
    )
    t0 = time.perf_counter()
    res = tr.fit(seed=0, log=lambda msg: log(f"  {msg}"))
    seconds = time.perf_counter() - t0
    ap = res["test metrics"]["average_precision"]
    losses = res["train losses"]
    mean, std = FIT_BAND
    log(f"  fixture fit: test AP {ap:.4f} (JAX band {mean} +- {std}; floor {FIT_AP_FLOOR}), "
        f"epoch losses {[round(x, 4) for x in losses]} (least must be < {FIT_LOSS_CEIL}), "
        f"{seconds:.1f} s")
    if not (ap > FIT_AP_FLOOR and min(losses) < FIT_LOSS_CEIL and np.isfinite(losses).all()):
        raise AssertionError(f"fixture fit below the floors: AP {ap}, losses {losses}")
    return {"test_ap": ap, "train_losses": losses, "seconds": seconds,
            "test_metrics": res["test metrics"], "validate_metrics": res["validate metrics"]}


def run_tgat_fit(dev) -> dict:
    """Phase 6, TGAT: fit on the JAX test fixture, held to the JAX floors."""
    from dyglib_tpu_torch.data import synthetic_link_prediction_data
    from dyglib_tpu_torch.models import TGAT
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    data = synthetic_link_prediction_data(
        num_src=120, num_dst=60, num_edges=2000, node_feat_scale=1.0, seed=7
    )
    save_path = os.path.join(REPO_ROOT, "dyglib_tpu_torch", "build", "chip_smoke_tgat_fit.pkl")
    tr = LinkPredictionTrainer(
        TGAT(num_neighbors=10, num_layers=2, time_feat_dim=DT_DIM), data,
        TrainConfig(batch_size=B, num_epochs=4, learning_rate=1e-3, patience=5),
        save_path=save_path, device=dev,
    )
    t0 = time.perf_counter()
    res = tr.fit(seed=0, log=lambda msg: log(f"  {msg}"))
    seconds = time.perf_counter() - t0
    test = res["test metrics"]
    ap, auc = test["average_precision"], test["roc_auc"]
    mean, std = TGAT_FIT_BAND
    log(f"  TGAT fixture fit: test AP {ap:.4f} (JAX band {mean} +- {std}; floor "
        f"{TGAT_FIT_AP_FLOOR}), AUC {auc:.4f} (floor {TGAT_FIT_AUC_FLOOR}), epoch losses "
        f"{[round(x, 4) for x in res['train losses']]}, {seconds:.1f} s")
    if not (ap > TGAT_FIT_AP_FLOOR and auc > TGAT_FIT_AUC_FLOOR):
        raise AssertionError(f"TGAT fixture fit below the floors: AP {ap}, AUC {auc}")
    return {"test_ap": ap, "test_auc": auc, "train_losses": res["train losses"],
            "seconds": seconds, "validate_metrics": res["validate metrics"]}


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

    from dyglib_tpu_torch.data import synthetic_link_prediction_data

    t0 = time.perf_counter()
    data = synthetic_link_prediction_data(num_src=8227, num_dst=1000, num_edges=157474, seed=1)
    log(f"synthetic stream: {data.full.num_interactions} edges, val "
        f"{data.val.num_interactions}, built in {time.perf_counter() - t0:.1f} s")

    # ---- 3. kernels against their plain versions
    log("kernels vs plain versions (tolerance: time_channel and patch_projection "
        f"atol {KERNEL_ATOL}, cooccurrence exact):")
    kernel_results = check_kernels(dev)
    log(f"training kernels vs plain versions (gradients within {GRAD_RTOL} of sum|terms|, "
        "window_fetch bitwise):")
    kernel_results.update(check_training_kernels(dev))
    log(f"TGAT kernels vs plain versions (atol {KERNEL_ATOL}):")
    kernel_results.update(check_tgat_kernels(data, dev))
    log(f"TGAT backward kernels vs plain backwards (gradients within {GRAD_RTOL} of sum|terms|, "
        "a second launch bitwise equal):")
    kernel_results.update(check_tgat_backward_kernels(data, dev))

    # ---- 4. the main paths
    log(f"TGAT evaluation path (probability tolerance {PROB_ATOL}):")
    tgat_run = run_tgat(data, TGAT_BATCHES, dev)
    torch.cuda.empty_cache()
    log(f"DyGFormer evaluation path (probability tolerance {PROB_ATOL}):")
    runs, train_runs = {}, {}
    for config, maxlen, patch, n_batches, _ in CONFIGS:
        runs[config] = run_config(
            data, config, maxlen, patch, n_batches, dev, cpu_reference=config == "wikipedia"
        )
    log(f"training path (lockstep: losses within {LOSS_ATOL}, gradients within "
        f"{GRAD_STEP_RTOL} of their largest entries; free-running: first loss within "
        f"{LOSS_ATOL}, later ones within {LOSS_DRIFT_ATOL}, parameters within 2 x steps x lr "
        f"{TRAIN_LR}):")
    for config, maxlen, patch, _, n_steps in CONFIGS:
        train_runs[config] = run_training(data, config, maxlen, patch, n_steps, dev)
        torch.cuda.empty_cache()
    log(f"TGAT training path ({TGAT_TRAIN_STEPS} steps a sweep; lockstep as above, and one "
        f"step at dropout {TGAT_DROPOUT}):")
    tgat_train = run_tgat_training(data, dev)
    log("TGAT with the uniform strategy:")
    run_tgat_uniform(data, dev)
    torch.cuda.empty_cache()
    log("fit on the JAX test fixture:")
    run_fit(dev)
    run_tgat_fit(dev)

    # ---- 5. results
    rows = []
    replaces = {
        "time_channel": "dyglib_tpu/ops/pallas/time_channel.py:119",
        "time_channel_bwd": "dyglib_tpu/ops/pallas/time_channel.py:201",
        "cooccurrence": "dyglib_tpu/ops/pallas/cooccurrence.py:35",
        "patch_projection": "dyglib_tpu/ops/pallas/patch_projection.py:59",
        "patch_projection_bwd": "dyglib_tpu/ops/pallas/patch_projection.py:71",
        "window_fetch": "dyglib_tpu/ops/pallas/window_fetch.py:51",
        "temporal_attention": "dyglib_tpu/ops/pallas/temporal_attention.py:99",
        "gathered_attention": "dyglib_tpu/ops/pallas/gathered_attention.py:83",
        "window_attention": "dyglib_tpu/ops/pallas/window_attention.py:133",
        "phi_projection": "dyglib_tpu/ops/pallas/phi_projection.py:48",
        "temporal_attention_bwd": "dyglib_tpu/ops/pallas/temporal_attention.py:109",
        "gathered_attention_bwd": "dyglib_tpu/ops/pallas/gathered_attention.py:97",
        "window_attention_bwd": "dyglib_tpu/ops/pallas/window_attention.py:167",
        "phi_projection_bwd": "dyglib_tpu/ops/pallas/phi_projection.py:56",
    }

    def main_path_launches(kernel, config):
        """Forward kernels: the evaluation sweep; backward kernels: the
        training sweep; window_fetch: its entry-fetch training sweep; TGAT's
        kernels: the first evaluation (forward) or training (backward)
        sweep of their configuration."""
        if kernel in TGAT_KERNEL_CONFIG:
            return tgat_run["launches"][TGAT_KERNEL_CONFIG[kernel]][kernel]
        if kernel.removesuffix("_bwd") in TGAT_KERNEL_CONFIG:
            return tgat_train["launches"][TGAT_KERNEL_CONFIG[kernel.removesuffix("_bwd")]][kernel]
        if kernel == "window_fetch":
            return train_runs[config]["window_fetch_launches"]
        if kernel.endswith("_bwd"):
            return train_runs[config]["launches"][kernel]
        return runs[config]["launches"][kernel]

    for (kernel, config), entry in kernel_results.items():
        parts = entry["parts"]
        nbytes = sum(p["bytes"] for p in parts)
        nops = sum(p["ops"] for p in parts)
        ops_peak = parts[0].get("ops_peak", PEAK_F32_OPS)
        sfu = sum(p.get("sfu_ops", 0) for p in parts)
        b_ms, b_by = bound_ms(nbytes, nops, ops_peak)
        if sfu / PEAK_SFU_OPS * 1e3 > b_ms:
            b_ms, b_by = sfu / PEAK_SFU_OPS * 1e3, "operations"
        libs = [p["library_ms"] for p in parts]
        rows.append({
            "name": f"{kernel}@{config}",
            "route": "cuda",
            "source": f"dyglib_tpu_torch/csrc/{kernel.removesuffix('_bwd')}.cu",
            "replaces": replaces[kernel],
            "launches": main_path_launches(kernel, config),
            "max_abs_err": max(p["max_abs_err"] for p in parts),
            "ms": sum(p["ms"] for p in parts),
            "plain_ms": sum(p["plain_ms"] for p in parts),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None if None in libs else sum(libs),
            # each part's own times (TGAT's backwards: hop 0 and hop 1)
            "parts": [{k: p[k] for k in ("part", "ms", "plain_ms", "library_ms")}
                      for p in parts],
            # TGAT's yardsticks time only the K/V products (or Phi @ W), and
            # in the backward the two weight-gradient products
            "library_partial": kernel.removesuffix("_bwd") in TGAT_KERNEL_CONFIG,
        })
        if ops_peak == PEAK_TF32_OPS:
            cuda_core_ms = nops / SPLIT_TF32_PASSES / PEAK_F32_OPS * 1e3
            rows[-1]["bound_note"] = (
                f"tensor cores, {SPLIT_TF32_PASSES} TF32 passes: {nops / 1e9:.1f} G operations, "
                f"{nops / PEAK_TF32_OPS * 1e3:.4f} ms at 495 T/s; bytes "
                f"{nbytes / PEAK_BYTES * 1e3:.4f} ms"
                + (f"; {sfu / 1e6:.1f} M cosines (and sines), {sfu / PEAK_SFU_OPS * 1e3:.4f} ms "
                   "at the SFU's 16 a clock per SM" if sfu else "")
                + f"; on the f32 CUDA cores the same product would be bound at "
                f"{cuda_core_ms:.4f} ms")
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
