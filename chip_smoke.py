#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA H100 and check them.

    python3 chip_smoke.py            (from the root of a checkout)

The main paths are TGAT, DyGFormer, TGN, DyRep, JODIE, GraphMixer, TCL
and CAWN link-prediction evaluation
(``dyglib_tpu_torch.train.LinkPredictionTrainer.evaluate``) and training
(``LinkPredictionTrainer.train_step`` over train batches, and ``fit``),
EdgeBank's evaluation (``evaluate_edge_bank_link_prediction``), node
classification (``NodeClassificationTrainer.evaluate`` and ``train_step``
on a frozen backbone) and DyGLib's four CLI drivers
(``dyglib_tpu_torch.cli.*.main``), each model at its published widths
(TGAT: 20 neighbours, 2 layers, 2 heads; DyGFormer: channel embedding 50,
2 layers, 2 heads; TGN and DyRep: 10
neighbours, 1 layer, 2 heads, memory 172; JODIE: memory 172; GraphMixer:
30 neighbours, 2 layers, time gap 2000; TCL: 20 neighbours, 2 layers, 2
heads; CAWN: 32 neighbours, walk length 1, 8 walk heads, position
features 172; all: time features 100, node and edge features 172), random
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
     yardsticks partial: the two weight-gradient products); the temporal
     attention forward and backward at TGN's shape (M = 600, K = 10; kv =
     the memory view + node rows of the first val batch's neighbours, from
     the memory after the last train batches), the same checks;
  3b. the bf16 variants of the time channel (#1, #1b) and the patch
     projection (#3, #3b) at the wikipedia and CanParl shapes against their
     plain bf16 versions (each output and gradient within GRAD_RTOL of its
     sum of |terms|; the bf16 patch projection's output, rounded to bf16
     twice, also within a bf16 ulp of its product and one of itself, the
     entries past GRAD_RTOL counted and held under 1 in 1000), a second
     launch bitwise equal; times of the variant, its split-TF32 sibling,
     the plain version and the library call (#3: torch.addmm in bf16;
     #1, #1b, #3b: the bf16 torch.mm(s) on a precomputed Phi or x, partial);
     bounds at 989 T/s in bf16, the bytes (x read as bf16), or the SFU;
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
  5m. TGN, DyRep and JODIE (time shifts from the train split), each: the
     first 20 val batches from the memory after the last 20 train batches,
     plain and kernel paths in turns (four sweeps each): counters zeroed
     just before each sweep and read just after (TGN and DyRep launch one
     temporal attention a batch, JODIE and the plain path none), finite
     probabilities, metrics in range, every sweep within the probability
     tolerance of the first plain sweep, the final memory bitwise equal on
     the two paths for TGN and JODIE (no kernel touches it) and, for DyRep,
     whose messages carry the attention's output, its largest gap and the
     batch where it fell printed and held within MEMORY_GAP_RTOL of
     max|memory|, the first batches against the port's CPU path; then the
     last 5 train batches from the memory before them, dropout 0, in turns:
     launches per step (TGN: one temporal attention and its backward;
     DyRep: the forward only, its loss reading the updated memories; JODIE
     none), a finite gradient for every parameter the loss reaches and none
     for the others (DyRep's attention, merge and time encoder; JODIE's
     time encoder), and one lockstep step as TGAT's; ms per eval batch and
     per train step;
  5n. GraphMixer, TCL and CAWN (no kernel on their paths), each: the first
     20 val batches twice (no launch, the rows each batch embeds: the
     triple for GraphMixer and TCL, the quad for CAWN; finite
     probabilities, metrics in range, the two sweeps bitwise equal), the
     first batches against the port's CPU path within PROB_ATOL (CAWN, whose
     neighbours the card's generator draws: the card's sampled inputs
     through the CPU net), 5 train steps on the last train batches at
     dropout 0 (finite losses, a finite gradient for every trainable
     parameter the loss reaches, none for GraphMixer's frozen time encoder
     and CAWN's backward-direction recurrent weights); GraphMixer's node
     encoder by gather against its prefix sums on one batch; TCL under
     uniform sampling (the quad, two equal sweeps); ms per eval batch and
     per train step. EdgeBank on the test split under random (unlimited
     memory), historical and inductive (repeat-threshold memory)
     negatives, card against the CPU path: equal 0/1 probabilities, losses
     and metrics; ms per batch. TGAT (default kernels) and TGN evaluate 20
     val batches under historical and inductive negatives: the quad (4B
     rows a batch), the launches per batch of the random protocol, the
     first batches against the CPU path; ms per batch;
  5b. bf16 compute (``compute_dtype="bfloat16"``) for DyGFormer 32/1 and
     CanParl, TGAT (default kernels) and CAWN at the published widths,
     dropout 0, seed-0 weights: the val batches through the kernels
     (counters zeroed just before and read just after: the bf16 variants
     and the co-occurrence count launched for DyGFormer, TGAT's attention
     kernels, no split-TF32 variant anywhere), finite probabilities within
     half the plain bf16 path's bf16-vs-f32 gap of that path, and
     BF16_PROB_ATOL at most (CAWN, which runs no kernel: of the port's CPU
     path on the first batch, within half its own gap), the kernel path's
     own gap at least half the plain path's; train steps over the last
     train batches (the bf16 backward variants launched, no split-TF32
     one), the kernel and plain paths in lockstep (losses within half the
     free-running bf16-vs-f32 loss gap, and BF16_LOSS_ATOL at most); ms per
     eval batch and per train step, f32 and bf16 in BF16_TURNS, by the loop
     and by the captured scan path (DyGFormer 32/1 and TGAT: each bf16
     capture checked against its loop as in 5s, within SCAN_ATOL, and its
     replays traced: the bf16 variants' launches in the trace are the
     printed ``scan_launches`` of their rows). DyGFormer CanParl with remat
     against without, dropout 0.1, REMAT_STEPS train steps from the same
     weights and dropout seed, in turns: per-step gradients equal (bitwise,
     or within REMAT_GRAD_RTOL of each tensor's largest entry: the indexed
     rows' gradients are summed by atomics), the dropout generator equal
     after every step, losses equal, peak device memory above the weights
     and ms per step for each; a captured remat scan epoch against its loop
     within SCAN_ATOL, generators equal, in f32 and in bf16;
  5c. node classification and the CLI: the same stream split by the
     node-classification rule; DyGFormer 32/1 (2 layers), TGAT (K = 20, 2
     layers) and TGN (K = 10, 1 layer) at the published wikipedia
     node-classification widths, built from the CLI's arguments by
     ``build_backbone``, backbone and head from seed 0: the first 20 val
     batches (TGN from the memory after the last 20 train batches), plain
     and kernel paths in turns P, K, K, P, counters zeroed just before each
     sweep and read just after (DyGFormer #1 x1, #2 x2, #3 x2 a batch; TGAT
     #6 x2, #5 x1; TGN #5 x1; the plain path none), probabilities within
     PROB_ATOL of the first plain sweep, the two kernel sweeps bitwise
     equal, DyGFormer's first batches against the port's CPU path; then 5
     head steps on the last train batches at head dropout 0 in lockstep
     with the plain path (losses within LOSS_ATOL, head gradients within
     GRAD_STEP_RTOL of each tensor's largest entry), the forward kernels
     launched and no backward kernel, every backbone parameter bitwise
     unchanged with no ``.grad``; ms per eval batch and per head step, the
     val AUC. The JAX slow test's relabelled fixture (4000 edges, seed 7,
     labels under seed 777), a random TGAT backbone (K = 10, 1 layer), 5
     head epochs: val AUC at least 0.70. The four drivers in a temporary
     working directory on a 6000-edge ``write_synthetic_dataset`` stream,
     for DyGFormer and TGN (``--load_best_configs``): link-prediction
     training (1 epoch), evaluation under historical negatives,
     node-class training (2 epochs) and evaluation; the artifacts in
     DyGLib's layout, every aggregate finite and in [0, 1], each driver's
     wall seconds;
  5s. scan epochs as CUDA graphs (``TrainConfig(scan_epochs=True)``, no
     sequence buckets, dropout 0, train negatives seeded 13): for each path
     a train epoch then an eval sweep from the state it leaves, once by the
     per-batch loop and once captured (each sweep's first step eager, every
     later one a graph replay), from one snapshot of weights, optimizer
     state and generators: losses, probabilities, weights and the memory's
     floats within SCAN_ATOL, clocks, flags and generator states equal, the
     loop's launches of every kernel equal to the captured run's eager
     (warm-up) launches plus its replays' (captured launches x replays),
     each kernel replayed; then one more captured run, replays only, under
     ``torch.profiler``: each kernel's device launches counted by name in
     the trace (TRACE_KERNELS) must equal the replays' reckoning and the
     loop's counts, and are the ``scan_launches`` printed. DyGFormer 32/1,
     TGAT (K = 20, 2 layers) and TGN
     (from the memory the 20 train batches before leave) over the last 10
     train and the first 20 val batches, and DyGFormer's node-class head
     epoch (10 train batches) and eval sweep (20 val batches), each then
     timed in turns loop, graph, graph, loop (medians of ms per train step
     and eval batch); TGAT under ``uniform`` (the sampling generators
     registered with the graphs) over 5 and 5 batches; TGAT window (#7,
     #7b), Phi fusion (#8, #8b) and DyGFormer's entry fetch (#4) one
     replay each; DyRep, JODIE, GraphMixer, TCL and CAWN two replays each.
     TGAT under ``uniform`` again: eval sweeps with salts 0, 2 and 0 through
     one cached graph (its generator re-seeded a sweep) against eager sweeps
     with those salts; and a 2-epoch ``fit`` on the JAX test fixture (TGAT
     ``uniform``, K = 10, 2 layers, dropout 0.1) with ``scan_epochs``
     against the same ``fit`` on the loop's steps (and the scan mode's
     ``capturable`` Adam): every metric, the train losses and the
     checkpoint's weights within SCAN_ATOL;
  6. fit on the JAX test fixture (the 2000-edge synthetic stream of
     tests/conftest.py): DyGFormer 32/2, 2 layers, dropout 0.1, 4 epochs,
     lr 5e-4, test AP above 0.50 and the least epoch loss below 0.67
     (tests/test_remaining_models.py); TGAT K = 10, 2 layers, 4 epochs,
     lr 1e-3, default kernels, test AP above 0.58 and AUC above 0.57
     (tests/test_tgat_end_to_end.py); TGN, JODIE and DyRep K = 5, 1 layer,
     2 epochs, lr 1e-3, train negatives seeded 13, test AP above 0.57, 0.58
     and 0.39 (tests/test_memory_models.py); GraphMixer K = 10, time gap
     200, 3 epochs, test AP above 0.75 (tests/test_graphmixer.py); TCL K =
     10, 2 layers, 4 train epochs (the last epoch's mean loss below 0.93 x
     the first's and below 0.69) and test AP above 0.53 from the final
     weights; CAWN K = 8, walk length 1, 8 heads, 2 epochs, test AP above
     0.58 (tests/test_remaining_models.py); lr 1e-3: the JAX package's floors;
  5d. the rank grid (``dyglib_tpu_torch.parallel``): the native CSR
     builder (g++ at first use) against the numpy path on the 157,474-edge
     stream, identical arrays, both build times; then a one-rank NCCL
     process group (TCP store on a free localhost port) and the (1, 1)
     mesh: TGAT default, DyGFormer 32/1 and TGN at their published widths
     and dropout, MESH_STEPS train steps on the last train batches and the
     first MESH_BATCHES val batches, with and without the mesh from the
     same seed-0 weights and generators: losses, probabilities, parameters
     and TGN's whole memory within MESH_ATOL (one rank's collectives are
     copies); every kernel of the model's path launched on the mesh path
     (MESH_KERNELS); each step's collectives (calls and bytes per call
     site) equal to the CPU tests' reckoning (``expected_collectives``);
     ms per train step and eval batch, no mesh against mesh, in
     MESH_TURNS; TGAT's ``train_epoch_scanned`` under the mesh (CUDA
     graphs holding the NCCL collectives) against its loop within
     SCAN_ATOL; the group destroyed; with two or more cards, the TGAT
     steps at two NCCL ranks against one device (rtol 2e-3), else one
     line saying the run was not possible;
  7. print one JSON line of kernel numbers (each row with its main-path
     launches (the bf16 variants: phase 5b's DyGFormer sweeps; their rows
     also carry their split-TF32 siblings' ms), where phase 5c runs it its node-classification launches
     over 20 eval batches, its launches by phase 5s's replays, and its
     launches on phase 5d's mesh path), then the device JSON line.
"""
import dataclasses
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
# bf16 on the tensor cores, dense (the bf16 variants' one pass)
PEAK_BF16_OPS = 989e12
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


# TGN, DyRep and JODIE at their published widths (bench.py:94-100: TGN and
# DyRep K = 10 neighbours, 1 layer, 2 heads; memory 172 = the node features,
# Dt = 100; JODIE samples none), time shifts from the train split. Per
# model: the kernels an eval batch launches, and those a train step
# launches. DyRep's loss reads the updated memories, not the attention's
# output (which only feeds its messages, outside autograd), so its train
# step runs no attention backward; JODIE has no attention.
MEMORY_K, MEMORY_BATCHES, MEMORY_TRAIN_STEPS, MEMORY_WARM = 10, 20, 5, 20
# the memory models' sweeps, in turns: plain, kernels, kernels, plain, twice
MEMORY_TURNS = (False, True, True, False) * 2
MEMORY_MODELS = {
    "TGN": ({"temporal_attention": 1},
            {"temporal_attention": 1, "temporal_attention_bwd": 1}),
    "DyRep": ({"temporal_attention": 1}, {"temporal_attention": 1}),
    "JODIE": ({}, {}),
}
# parameters each model's loss does not reach (no gradient on either path)
MEMORY_UNREACHED = {"TGN": (), "DyRep": ("temporal_conv_", "merge_", "time_encoder."),
                    "JODIE": ("time_encoder.",)}
# DyRep's messages carry the attention's output: its memory after the
# kernel path's eval sweep is held to this share of max|memory| of the plain
# path's (TGN's and JODIE's must be bitwise equal: no kernel touches them)
MEMORY_GAP_RTOL = 1e-3
# the JAX package's test AP floors of the fixture fits
# (tests/test_memory_models.py)
MEMORY_FIT_AP_FLOOR = {"TGN": 0.57, "JODIE": 0.58, "DyRep": 0.39}


# GraphMixer, TCL and CAWN at their published wikipedia widths
# (dyglib_tpu/configs/best_configs.py): time features 100; TCL's uniform
# variant (reddit, CanParl) is asked for apart. No kernel runs on their
# paths: the JAX models reach no Pallas kernel.
NEW_MODELS = {
    "GraphMixer": dict(num_neighbors=30, num_layers=2, dropout=0.5, time_gap=2000,
                       time_feat_dim=DT_DIM),
    "TCL": dict(num_neighbors=20, num_layers=2, num_heads=2, dropout=0.1, time_feat_dim=DT_DIM),
    "CAWN": dict(num_neighbors=32, walk_length=1, num_walk_heads=8, position_feat_dim=FEAT,
                 time_feat_dim=DT_DIM, dropout=0.1),
}
# parameters no loss reaches: GraphMixer's frozen time encoder, and CAWN's
# backward-direction recurrent weights (that direction runs one step from 0)
NEW_UNREACHED = {"GraphMixer": ("time_encoder.",), "TCL": (),
                 "CAWN": ("feature_encoder.bwd_wh", "position_encoder.bwd_wh")}
NEW_BATCHES, NEW_TRAIN_STEPS = 20, 5
# EdgeBank's memory under each negative strategy (best_configs.py)
EDGEBANK_MODES = {"random": "unlimited_memory", "historical": "repeat_threshold_memory",
                  "inductive": "repeat_threshold_memory"}
# the fixture fits of the JAX tests (tests/test_graphmixer.py,
# tests/test_remaining_models.py): (kwargs, epochs, test AP floor)
NEW_FIT = {
    "GraphMixer": (dict(num_neighbors=10, num_layers=2, time_gap=200), 3, 0.75),
    "TCL": (dict(num_neighbors=10, num_layers=2), 4, 0.53),
    "CAWN": (dict(num_neighbors=8, walk_length=1, num_walk_heads=8), 2, 0.58),
}


# node classification (phase 5c) at the published wikipedia widths
# (load_node_classification_best_configs: DyGFormer 32/1 with 2 layers, TGAT
# K = 20 with 2 layers, TGN K = 10 with 1 layer; all "recent", dropout 0.1),
# backbone and head from seed 0: the forward kernels an eval batch and a head
# step launch (the frozen backbone launches no backward kernel)
NODECLS_MODELS = {
    "DyGFormer": {"time_channel": 1, "cooccurrence": 2, "patch_projection": 2},
    "TGAT": {"gathered_attention": 2, "temporal_attention": 1},
    "TGN": {"temporal_attention": 1},
}
# the kernel rows whose configuration is each model's node-class width
NODECLS_KERNEL_ROWS = {"wikipedia": "DyGFormer", "tgat": "TGAT", "tgn": "TGN"}
NODECLS_BATCHES, NODECLS_STEPS = 20, 5
NODECLS_TURNS = (False, True, True, False)
# the JAX package's slow test_node_cls_discriminative_auc_floor
# (tests/test_node_classification_and_cli.py:268-324): relabelled fixture,
# random TGAT backbone (K = 10, 1 layer), 5 head epochs, val AUC floor
NODECLS_FIXTURE_AUC_FLOOR = 0.70
# the four drivers' dataset (write_synthetic_dataset) and models
DRIVER_EDGES = 6000
DRIVER_MODELS = ("DyGFormer", "TGN")


# scan epochs as CUDA graphs (phase 5s): TrainConfig(scan_epochs=True), so a
# sweep's first step runs eagerly and every later one replays its graph,
# against the per-batch loop from the same parameters, optimizer state and
# generator states (dropout 0, seeded train negatives, no sequence
# buckets), at the atol of the JAX tests/test_scan_epoch.py
SCAN_ATOL = 1e-5
SCAN_TRAIN_BATCHES, SCAN_EVAL_BATCHES = 10, 20
# the loop (False) and the captured sweeps (True), timed in turns
SCAN_TURNS = (False, True, True, False)
# (train, eval) batches of the other captures: one replay each for the
# non-default configurations, two for the models without kernels
SCAN_ONE_REPLAY, SCAN_TWO_REPLAYS = (2, 2), (3, 3)
# the eval salts of the cached-graph check (fit's val sweep, its test
# sweep, and val again) and its batches
SCAN_SALTS, SCAN_SALT_BATCHES = (0, 2, 0), 5
# the device kernel each wrapper launches once a call, as the profiler names
# it (regular expressions on the demangled names; a wrapper's other
# launches, partial sums and memsets, are not counted)
TRACE_KERNELS = {
    "time_channel": r"time_channel_fwd_kernel<.*SplitTf32",
    "time_channel_bwd": r"time_bwd_kernel<\d+, true, \d+, .*SplitTf32",
    "cooccurrence": r"cooccurrence_(pairs|table)_kernel",
    "patch_projection": r"patch_forward_kernel",
    "patch_projection_bwd": r"patch_backward_kernel",
    "time_channel_bf16": r"time_channel_fwd_kernel<.*Bf16",
    "time_channel_bf16_bwd": r"time_bwd_kernel<\d+, true, \d+, .*Bf16",
    "patch_projection_bf16": r"patch_forward_bf16_kernel",
    "patch_projection_bf16_bwd": r"patch_backward_bf16_kernel",
    "window_fetch": r"window_fetch_kernel",
    "temporal_attention": r"\battention_query_kernel<.*KvLoader",
    "temporal_attention_bwd": r"attention_bwd_query_kernel<.*KvLoader",
    "gathered_attention": r"\battention_query_kernel<.*GatheredLoader",
    "gathered_attention_bwd": r"attention_bwd_query_kernel<.*GatheredLoader",
    "window_attention": r"\battention_query_kernel<.*WindowLoader",
    "window_attention_bwd": r"attention_bwd_query_kernel<.*WindowLoader",
    "phi_projection": r"phi_fwd_kernel",
    "phi_projection_bwd": r"time_bwd_kernel<\d+, false",
}


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


def attention_fwd_ops(m, k, kv_dim, dq, heads) -> int:
    """The operations a temporal attention forward needs, which the kernels
    compute (reassociated: no kv row projected): qk = Wk_h q3_h and out_h =
    Av_h Wv_h (2 dq kv_dim each a query), the logits and Av = sum_j w kv_j
    (2 kv_dim each per (query, head, neighbor)), ~6 for the mask, softmax
    and keep."""
    return 4 * m * dq * kv_dim + 4 * m * heads * k * kv_dim + 6 * m * heads * k


def attention_bwd_ops(m, k, kv_dim, dq, heads, kv_cols, phi_cols=0) -> int:
    """The operations of the reassociated attention backward: qk, gv, dq3,
    dWk, dWv (10 dq kv_dim a query); logits, ds_d, Ak, Av (8 kv_dim per
    (query, head, neighbor)); dkv's needed columns (4 each); ~12 for the
    softmax's backward; Phi's argument (2) and -sin * dPhi, dtb, dtw (5) per
    kv row and Phi column where dtw and dtb are returned."""
    return (10 * m * dq * kv_dim + 8 * m * heads * k * kv_dim + 4 * m * heads * k * kv_cols
            + 12 * m * heads * k + 7 * m * k * phi_cols)


def attention_small_bytes(m, k, kv_dim, dq, heads, backward: bool) -> int:
    """Bytes of an attention kernel's operands but its kv rows: q3, mask,
    keep, the weights, the output (and in the backward dout, dq3 and the
    weights' gradients)."""
    if backward:
        return 4 * (3 * m * dq + 2 * m * k + m * heads * k + 4 * kv_dim * dq)
    return 4 * (2 * m * dq + 2 * m * k + m * heads * k + 2 * kv_dim * dq)


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


def bf16_ulp(v):
    """One bf16 unit in the last place of each |v| (8 bits of precision)."""
    import torch

    return torch.ldexp(torch.ones_like(v, dtype=torch.float32),
                       torch.frexp(v.float()).exponent - 8)


def check_bf16_kernels(dev) -> dict:
    """Phase 3b: the bf16 variants of the time channel (#1, #1b) and the
    patch projection (#3, #3b) against their plain bf16 versions at the
    main path's shapes, each output and gradient within GRAD_RTOL of its
    sum of |terms| (the bf16 patch projection's output, which is rounded to
    bf16 twice, also within one bf16 ulp of the product and one of the
    output: a sum that the two take in another order may fall on either
    side of a rounding boundary), a second launch bitwise equal; times of
    the variant, its split-TF32 sibling, the plain version and the library
    call; bounds at 989 T/s (bf16) or the SFU."""
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.nn.modules import time_encoder_spectrum

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2468)
    m = 3 * B
    results = {}

    def record(key, part, err, rel, ms, sibling, plain, lib, nbytes, nops, sfu=0, flips=0):
        results[key] = {"parts": [dict(part=part, max_abs_err=err, ms=ms, plain_ms=plain,
                                       library_ms=lib, bytes=nbytes, ops=nops,
                                       ops_peak=PEAK_BF16_OPS, sfu_ops=sfu,
                                       sibling_ms=sibling, rounding_flips=flips)]}
        log(f"  {key[0]:<24} {key[1]:<9} {part:<26} err {err:.3g} ({rel:.3g} of sum|terms|"
            f"{f', {flips} one-ulp rounding flips' if flips else ''})  kernel {ms:.4f} ms  "
            f"split-TF32 {sibling:.4f} ms  plain {plain:.4f} ms  library {lib:.4f} ms")

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    for config, maxlen, patch, _, _ in CONFIGS:
        lp = maxlen
        rows = m * (lp // patch)
        iters = 20 if lp > 100 else 200
        # ---- time channel, forward and backward
        dt = torch.randint(0, 1_000_000, (m, lp), device=dev, generator=gen).float()
        valid = torch.rand((m, lp), device=dev, generator=gen) < 0.8
        tw = torch.from_numpy(time_encoder_spectrum(DT_DIM)).reshape(-1).to(dev)
        tb = 0.1 * torch.randn(DT_DIM, device=dev, generator=gen)
        k = patch * DT_DIM
        w = ((torch.rand((CED, k), device=dev, generator=gen) * 2 - 1) * k**-0.5).t()
        bias = (torch.rand(CED, device=dev, generator=gen) * 2 - 1) * k**-0.5
        args = (dt, valid, tw, tb, w, bias, patch)
        out = ops.time_channel_projection(*args, compute_dtype=bf16)
        again = ops.time_channel_projection(*args, compute_dtype=bf16)
        ref = ops.time_channel_projection_plain(*args, compute_dtype=bf16)
        phi16 = torch.where(valid[..., None], torch.cos(dt[..., None] * tw + tb),
                            0.0).to(bf16).view(rows, k)
        w16 = w.to(bf16)
        terms = (phi16.float().abs() @ w16.float().abs() + bias.abs()).view(out.shape)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err, rel = diff.max().item(), (diff / terms.clamp_min(1e-30)).max().item()
        if out.dtype != torch.float32 or not rel <= GRAD_RTOL:
            raise AssertionError(f"time_channel_bf16@{config}: error {rel} of sum|terms| > "
                                 f"{GRAD_RTOL}")
        if not torch.equal(out, again):
            raise AssertionError(f"time_channel_bf16@{config}: a second launch differs")
        n_valid = int(valid.sum())
        record(
            ("time_channel_bf16", config), f"M{m} L{lp} patch{patch}", err, rel,
            cuda_ms(lambda: ops.time_channel_projection(*args, compute_dtype=bf16), iters),
            cuda_ms(lambda: ops.time_channel_projection(*args), iters),
            cuda_ms(lambda: ops.time_channel_projection_plain(*args, compute_dtype=bf16), iters),
            # partial: the bf16 product on a precomputed Phi
            cuda_ms(lambda: torch.mm(phi16, w16), iters),
            4 * m * lp + m * lp + 4 * (2 * DT_DIM + k * CED + CED + rows * CED),
            2 * rows * k * CED, sfu=n_valid * DT_DIM,
        )
        del out, again, ref, terms, diff

        dout = 1e-3 * torch.randn((m, lp // patch, CED), device=dev, generator=gen)
        bargs = (dt, valid, tw, tb, w, dout, patch)
        got = ops.time_channel_backward(*bargs, compute_dtype=bf16)
        again = ops.time_channel_backward(*bargs, compute_dtype=bf16)
        want = ops.time_channel_backward_plain(*bargs, compute_dtype=bf16)
        theta = dt[..., None] * tw + tb
        mask = valid[..., None]
        g16 = dout.reshape(rows, CED).to(bf16)
        g_abs = g16.float().abs()
        common = torch.where(
            mask, (g_abs @ w16.float().abs().t()).reshape(theta.shape) * torch.sin(theta).abs(),
            0.0)
        terms = ((common * dt[..., None]).sum((0, 1)), common.sum((0, 1)),
                 phi16.float().abs().t() @ g_abs, dout.reshape(rows, CED).abs().sum(0))
        torch.cuda.synchronize()
        err, rel = grad_errors(got, want, terms)
        if not rel <= GRAD_RTOL:
            raise AssertionError(f"time_channel_bf16_bwd@{config}: error {rel} of sum|terms| > "
                                 f"{GRAD_RTOL}")
        if not same(got, again):
            raise AssertionError(f"time_channel_bf16_bwd@{config}: a second launch differs")
        del theta, mask, common, got, again, want, terms
        record(
            ("time_channel_bf16_bwd", config), f"M{m} L{lp} patch{patch}", err, rel,
            cuda_ms(lambda: ops.time_channel_backward(*bargs, compute_dtype=bf16), iters // 2),
            cuda_ms(lambda: ops.time_channel_backward(*bargs), iters // 2),
            cuda_ms(lambda: ops.time_channel_backward_plain(*bargs, compute_dtype=bf16),
                    max(2, iters // 10)),
            # partial: the two bf16 products on a precomputed Phi
            cuda_ms(lambda: (torch.mm(phi16.t(), g16), torch.mm(g16, w16.t())), iters // 2),
            4 * m * lp + m * lp + 4 * (2 * DT_DIM + k * CED + rows * CED)
            + 4 * (k * CED + CED + 2 * DT_DIM),
            4 * rows * k * CED, sfu=2 * n_valid * DT_DIM,
        )
        del dt, valid, dout, args, bargs, phi16, g16, g_abs
        torch.cuda.empty_cache()

        # ---- patch projection, forward and backward: bf16 rows, pads zero
        x = torch.randn((m, lp, FEAT), device=dev, generator=gen).to(bf16)
        x[:, lp // 2 :, :] = 0.0
        k = patch * FEAT
        w = ((torch.rand((CED, k), device=dev, generator=gen) * 2 - 1) * k**-0.5).t()
        bias = (torch.rand(CED, device=dev, generator=gen) * 2 - 1) * k**-0.5
        out = ops.patch_projection(x, w, bias, patch, compute_dtype=bf16)
        again = ops.patch_projection(x, w, bias, patch, compute_dtype=bf16)
        ref = ops.patch_projection_plain(x, w, bias, patch, bf16, round_output=True)
        x2, w16, b16 = x.view(rows, k), w.to(bf16), bias.to(bf16)
        prod = (x2.float() @ w16.float()).view(out.shape)
        terms = (x2.float().abs() @ w16.float().abs() + bias.abs()).view(out.shape)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err, rel = diff.max().item(), (diff / terms.clamp_min(1e-30)).max().item()
        beyond = diff > GRAD_RTOL * terms
        flips = int(beyond.sum())
        allowed = GRAD_RTOL * terms + bf16_ulp(prod) + bf16_ulp(ref)
        if out.dtype != bf16 or not bool((diff <= allowed).all()):
            raise AssertionError(f"patch_projection_bf16@{config}: error {rel} of sum|terms|, "
                                 f"{flips} entries past {GRAD_RTOL} of it, some past two bf16 ulp")
        if flips > max(1, out.numel() // 1000):
            raise AssertionError(f"patch_projection_bf16@{config}: {flips} rounding flips")
        if not torch.equal(out, again):
            raise AssertionError(f"patch_projection_bf16@{config}: a second launch differs")
        del prod, terms, diff, beyond, allowed, out, again, ref
        x32 = x.float()
        record(
            ("patch_projection_bf16", config), f"M{m} Lp{lp} D{FEAT} patch{patch}", err, rel,
            cuda_ms(lambda: ops.patch_projection(x, w, bias, patch, compute_dtype=bf16), iters),
            cuda_ms(lambda: ops.patch_projection(x32, w, bias, patch), iters),
            cuda_ms(lambda: ops.patch_projection_plain(x, w, bias, patch, bf16, round_output=True),
                    iters),
            cuda_ms(lambda: torch.addmm(b16, x2, w16), iters),
            2 * m * lp * FEAT + 4 * (k * CED + CED) + 2 * rows * CED,
            2 * rows * k * CED, flips=flips,
        )
        del x32
        torch.cuda.empty_cache()

        dout = (1e-3 * torch.randn((m, lp // patch, CED), device=dev, generator=gen)).to(bf16)
        got = ops.patch_projection_backward(x, dout, patch, bf16)
        again = ops.patch_projection_backward(x, dout, patch, bf16)
        want = ops.patch_projection_backward_plain(x, dout, patch, bf16)
        g2 = dout.view(rows, CED)
        terms = (x2.float().abs().t() @ g2.float().abs(), g2.float().abs().sum(0))
        torch.cuda.synchronize()
        err, rel = grad_errors(got, want, terms)
        if not rel <= GRAD_RTOL:
            raise AssertionError(
                f"patch_projection_bf16_bwd@{config}: error {rel} of sum|terms| > {GRAD_RTOL}")
        if not same(got, again):
            raise AssertionError(f"patch_projection_bf16_bwd@{config}: a second launch differs")
        del got, again, want, terms
        x32, d32 = x.float(), dout.float()
        record(
            ("patch_projection_bf16_bwd", config), f"M{m} Lp{lp} D{FEAT} patch{patch}", err, rel,
            cuda_ms(lambda: ops.patch_projection_backward(x, dout, patch, bf16), iters),
            cuda_ms(lambda: ops.patch_projection_backward(x32, d32, patch), iters),
            cuda_ms(lambda: ops.patch_projection_backward_plain(x, dout, patch, bf16), iters),
            # partial: dW's bf16 product
            cuda_ms(lambda: torch.mm(x2.t(), g2), iters),
            2 * (m * lp * FEAT + rows * CED) + 4 * (k + 1) * CED,
            2 * rows * (k + 1) * CED,
        )
        del x, x2, g2, dout, x32, d32
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
        fwd_ops = lambda m: attention_fwd_ops(m, k, kv_dim, dq, heads)
        small = lambda m: attention_small_bytes(m, k, kv_dim, dq, heads, backward=False)

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

    bwd_ops = lambda m, kv_cols, phi_cols=0: attention_bwd_ops(
        m, k, kv_dim, dq, heads, kv_cols, phi_cols)
    small = lambda m: attention_small_bytes(m, k, kv_dim, dq, heads, backward=True)

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
            inputs = tr._sample(tr.full_csr, tr._batch_arrays(b, ns, nd), "dedup")
            emb_kernel = tr._embed(inputs, "dedup")
            tr.model.use_kernels = False
            emb_plain = tr._embed(inputs, "dedup")
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


def tgat_lockstep(tr, params, batches, dropout: float, align: bool = True,
                  state=None) -> dict:
    """TGAT's (or, given its ``state``, a memory model's) train steps in
    lockstep: at every step both paths' loss and gradients from the same
    parameters (the kernel path's trajectory; a memory model's from the
    kernel path's memory, committed after each step), the
    dropout generator reseeded the same way for both, then the kernel
    path's optimizer step. A parameter the loss does not reach has no
    gradient on either path. Returns the largest loss difference
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
    relus = {f"{n}.fc1": mod.fc1 for n, mod in tr.model.named_children()
             if n.startswith("merge_")}
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
            valid = arrays[6]
            out = {}
            for use_kernels in (True, False):
                path[0] = use_kernels
                if use_kernels:
                    for r in relus:
                        kernel_acts[r], calls[r] = [], 0
                tr.model.use_kernels = use_kernels
                tr.dropout_gen.manual_seed(1000 + step)
                inputs = tr._sample(tr.train_csr, arrays, "dedup", bucket)
                if state is None:
                    embs = tr._embed(inputs, "dedup", tr.dropout_gen)
                else:
                    embs, raw = tr._embed_memory(inputs, state, "dedup", tr.dropout_gen)
                    if use_kernels:
                        committed = tr._commit(state, arrays, raw.detach())
                loss, _ = tr._head_loss(embs, valid)
                out[use_kernels] = (float(loss.detach()),
                                    torch.autograd.grad(loss, weights, allow_unused=True))
            loss_diff = max(loss_diff, abs(out[True][0] - out[False][0]))
            top = max(float(g.abs().max()) for g in out[False][1] if g is not None)
            for (pname, _), gk, gp in zip(named, out[True][1], out[False][1]):
                if (gk is None) != (gp is None):
                    raise AssertionError(f"lockstep: {pname} has a gradient on one path only")
                if gk is None:
                    continue
                if not torch.isfinite(gk).all():
                    raise AssertionError(f"lockstep: {pname}'s gradient is not finite")
                if pname == "backbone.time_encoder.w":
                    continue
                scale = max(float(gp.abs().max()), 1e-3 * top)  # zero-in-theory tensors
                err = float((gk - gp).abs().max()) / scale
                if err > grad_err:
                    grad_err, worst = err, f"{pname} at step {step}"
            for p, g in zip(weights, out[True][1]):
                p.grad = g
            tr.optimizer.step()
            if state is not None:
                state = committed
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
        raise AssertionError(f"{name} lockstep: a ReLU input "
                             f"{stats['largest_flipped_input']} from zero changed sign between "
                             f"the paths (limit {FLIP_ATOL}; {stats['flips']})")
    if not (stats["loss_diff"] <= LOSS_ATOL and stats["grad_err"] <= GRAD_STEP_RTOL):
        raise AssertionError(f"{name} training in lockstep (dropout {dropout}): losses "
                             f"differ by {stats['loss_diff']}, gradients by "
                             f"{stats['grad_err']} of their largest entries ({stats['worst']}); "
                             f"ReLU inputs that changed sign: {stats['flips']}")
    return stats


def tgat_train_batches(data, tr, steps: int = TGAT_TRAIN_STEPS) -> list:
    """The last ``steps`` train batches, negatives from a seeded sampler set
    on ``tr``: [(arrays, bucket)]."""
    from dyglib_tpu_torch.graph import NegativeEdgeSampler

    tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=13)
    n = data.train.num_interactions
    stream = data.train.slice(n - steps * B, n)
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
                                       f"TGAT {name}", 0.0)
             for name in TGAT_CONFIGS if TGAT_CONFIGS[name][1]}
    dropped = {name: check_tgat_lockstep(
                   tgat_lockstep(trainers[name], params, batches[-1:], TGAT_DROPOUT),
                   f"TGAT {name}", TGAT_DROPOUT)
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


def memory_trainer(data, name, dev, dropout=0.1):
    """A trainer of one memory model at the published widths (MEMORY_K
    neighbours, 1 layer, 2 heads, memory 172, Dt 100; time shifts from the
    train split), seed-0 weights."""
    from dyglib_tpu_torch.models import MemoryModel, compute_src_dst_node_time_shifts
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    shifts = compute_src_dst_node_time_shifts(data.train.src, data.train.dst, data.train.ts)
    backbone = MemoryModel(model_name=name, num_neighbors=MEMORY_K, num_layers=1, num_heads=2,
                           time_feat_dim=DT_DIM, dropout=dropout, time_shifts=shifts)
    tr = LinkPredictionTrainer(backbone, data, TrainConfig(batch_size=B, learning_rate=TRAIN_LR),
                               device=dev)
    tr.init_params(0)
    return tr


def warm_memory(data, tr, skip_last: int = 0):
    """The memory after the MEMORY_WARM train batches that end ``skip_last``
    batches before the split's end, from an empty memory (an eval sweep:
    its positive edges committed)."""
    from dyglib_tpu_torch.graph import NegativeEdgeSampler

    n = data.train.num_interactions - skip_last * B
    stream = data.train.slice(n - MEMORY_WARM * B, n)
    sampler = NegativeEdgeSampler(data.train.src, data.train.dst, seed=13)
    return tr.evaluate(stream, sampler, state=tr.init_state())[3]


def check_memory_attention_kernels(data, dev) -> dict:
    """Phase 3 at TGN's shape: the temporal attention forward and backward
    (#5, #5b) at M = 600 (the B = 200 triple), K = MEMORY_K, kv = [memory
    view + node rows || edge rows || Phi(dt)] of the first val batch, from
    the memory after the last train batches, with TGN's seed-0 weights.
    The forward against its plain version (KERNEL_ATOL), the backward
    against its plain backward (dropout keep masks at p = 0.1; GRAD_RTOL of
    sum|terms|), second launches bitwise equal; times of the kernel, the
    plain version and the partial library yardstick (the K/V torch.mm's,
    and in the backward the two weight-gradient ones)."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.graph.csr import time_keys
    from dyglib_tpu_torch.ops import _attention

    tr = memory_trainer(data, "TGN", dev)
    state = warm_memory(data, tr)
    net = tr.model.eval()
    conv, k = net.temporal_conv_0, MEMORY_K
    heads = conv.num_heads
    wk, wv = conv.key_projection.weight.detach().t(), conv.value_projection.weight.detach().t()
    kv_dim, dq = wk.shape
    rng = np.random.RandomState(0)
    ids = np.concatenate([data.val.src[:B], data.val.dst[:B],
                          rng.randint(1, data.num_nodes, B)]).astype(np.int32)
    ts = np.tile(time_keys(data.val.ts[:B]), 3).astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(77)
    results = {}
    with torch.no_grad():
        inputs = tr.backbone.sample(tr.full_csr, torch.from_numpy(ids).to(dev),
                                    torch.from_numpy(ts).to(dev))
        hop0, hop1 = (h.reshape(-1).long() for h in inputs.hop_ids)
        m = hop0.shape[0]
        base = [net.view_rows(state, h)[0] + tr.tables.node[h] for h in (hop0, hop1)]
        dt = (inputs.hop_ts[0].reshape(-1, 1) - inputs.hop_ts[1].reshape(m, k)).float()
        phi0 = net.time_encoder(torch.zeros((m, 1), device=dev))[:, 0, :]
        q3 = conv.query_projection(torch.cat([base[0], phi0], dim=-1)).contiguous()
        nbr = base[1].reshape(m, k, -1)
        edge = tr.tables.edge[inputs.hop_eids[0].reshape(m, k).long()]
        phi = net.time_encoder(dt)
        mask = inputs.hop_mask[0].reshape(m, k).float()
        kv = torch.cat([nbr, edge, phi], dim=-1).reshape(m * k, kv_dim)
        part = f"M{m} K{k} Dkv{kv_dim} Dq{dq}"

        # forward, evaluation's keep mask (ones)
        args = (q3, nbr, edge, phi, mask, torch.ones((m, heads, k), device=dev), wk, wv, heads)
        got, again = ops.temporal_attention(*args), ops.temporal_attention(*args)
        want = ops.temporal_attention_plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("temporal_attention@tgn: two launches differ")
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"temporal_attention@tgn: max abs err {err} > {KERNEL_ATOL}")
        entry = dict(part=part, max_abs_err=err,
                     ms=cuda_ms(lambda: ops.temporal_attention(*args), 50, 3),
                     plain_ms=cuda_ms(lambda: ops.temporal_attention_plain(*args), 50, 3),
                     library_ms=cuda_ms(lambda: (torch.mm(kv, wk), torch.mm(kv, wv)), 50, 3),
                     bytes=attention_small_bytes(m, k, kv_dim, dq, heads, False)
                     + 4 * m * k * kv_dim,
                     ops=attention_fwd_ops(m, k, kv_dim, dq, heads))
        results[("temporal_attention", "tgn")] = {"parts": [entry]}
        b_ms, b_by = bound_ms(entry["bytes"], entry["ops"])
        log(f"  temporal_attention   {part:<24} err {err:.3g}  kernel {entry['ms']:.4f} ms  "
            f"plain {entry['plain_ms']:.4f} ms  library (partial: K/V mm's) "
            f"{entry['library_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})")

        # backward, training's keep mask (p = 0.1) and an output cotangent
        keep = (torch.rand((m, heads, k), device=dev, generator=gen) < 0.9) / 0.9
        dout = 1e-3 * torch.randn((m, dq), device=dev, generator=gen)
        args = (q3, nbr, edge, phi, mask, keep, wk, wv, dout, None, heads)
        got, again = ops.temporal_attention_backward(*args), ops.temporal_attention_backward(*args)
        want = ops.temporal_attention_backward_plain(*args)
        terms = ops.temporal_attention_backward_plain(*args, abs_terms=True)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("temporal_attention_bwd@tgn: two launches differ")
        if not all(torch.isfinite(a).all() for a in got):
            raise AssertionError("temporal_attention_bwd@tgn: a gradient is not finite")
        err, rel = grad_errors(got, want, terms)
        if not rel <= GRAD_RTOL:
            raise AssertionError(f"temporal_attention_bwd@tgn: error {rel} of sum|terms| > "
                                 f"{GRAD_RTOL}")
        key, val = _attention.project_kv(kv, wk, wv)
        _, dkey, dval = _attention.attend_backward(
            q3, key.view(m, k, -1), val.view(m, k, -1), mask, keep, dout, None, heads)
        dkey, dval = dkey.reshape(m * k, dq), dval.reshape(m * k, dq)
        entry = dict(part=part, max_abs_err=err,
                     ms=cuda_ms(lambda: ops.temporal_attention_backward(*args), 20, 3),
                     plain_ms=cuda_ms(lambda: ops.temporal_attention_backward_plain(*args), 20, 3),
                     library_ms=cuda_ms(lambda: (torch.mm(kv.t(), dkey), torch.mm(kv.t(), dval)),
                                        20, 3),
                     bytes=attention_small_bytes(m, k, kv_dim, dq, heads, True)
                     + 2 * 4 * m * k * kv_dim,
                     ops=attention_bwd_ops(m, k, kv_dim, dq, heads, kv_dim))
        results[("temporal_attention_bwd", "tgn")] = {"parts": [entry]}
        b_ms, b_by = bound_ms(entry["bytes"], entry["ops"])
        log(f"  temporal_attention_bwd {part:<22} err {err:.3g} ({rel:.3g} of sum|terms|)  "
            f"kernel {entry['ms']:.4f} ms  plain {entry['plain_ms']:.4f} ms  library (partial: "
            f"weight gradient mm's) {entry['library_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
    del tr, state, inputs, base, kv, key, val, dkey, dval
    torch.cuda.empty_cache()
    return results


def run_memory_eval(data, name, dev) -> dict:
    """Phase 4m for one memory model: the first MEMORY_BATCHES val batches
    from the memory after the last train batches, plain and kernel paths in
    turns (MEMORY_TURNS)."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.models import MemoryState
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    tr = memory_trainer(data, name, dev)
    start = warm_memory(data, tr)
    stream = data.val.slice(0, MEMORY_BATCHES * B)
    for use_kernels in (False, True):  # warm-up: allocator, cuBLAS
        tr.model.use_kernels = use_kernels
        tr.evaluate(data.val.slice(0, B), tr.val_neg, state=start)
    memories = []  # each batch's memory after its commit, of the current sweep
    eval_step = tr.eval_step

    def recording_step(*args, **kw):
        out = eval_step(*args, **kw)
        memories.append(out[2].memory)
        return out

    tr.eval_step = recording_step
    want = {k: v * MEMORY_BATCHES for k, v in MEMORY_MODELS[name][0].items()}
    ms, runs = {True: [], False: []}, {}
    for use_kernels in MEMORY_TURNS:
        tr.model.use_kernels = use_kernels
        memories.clear()
        torch.cuda.synchronize()
        ops.reset_launch_counts()  # just before the sweep
        t0 = time.perf_counter()
        losses, metrics, probs, state = tr.evaluate(stream, tr.val_neg, state=start)
        torch.cuda.synchronize()
        ms[use_kernels].append((time.perf_counter() - t0) / MEMORY_BATCHES * 1e3)
        counts = {k: v for k, v in ops.launch_counts().items() if v}  # just after
        if counts != (want if use_kernels else {}):
            raise AssertionError(f"{name} evaluation (kernels {use_kernels}): launched {counts}, "
                                 f"expected {want if use_kernels else {}}")
        if len(probs) != MEMORY_BATCHES or not all(
            pos.shape == neg.shape == (B,) and np.isfinite(pos).all() and np.isfinite(neg).all()
            for pos, neg in probs
        ):
            raise AssertionError(f"{name} evaluation: probabilities malformed or not finite")
        mean = tr.mean_metrics(metrics)
        if not all(0.0 <= v <= 1.0 for v in mean.values()) or not np.isfinite(losses).all():
            raise AssertionError(f"{name} evaluation: metrics out of range {mean}")
        runs.setdefault(use_kernels, (probs, state, list(memories), mean, counts))
        diff = max_prob_diff(probs, runs[False][0])
        if not diff <= PROB_ATOL:
            raise AssertionError(f"{name} evaluation: kernel vs plain probabilities differ by "
                                 f"{diff}")
    tr.eval_step = eval_step
    (k_probs, k_state, k_mems, mean, launches), (_, p_state, p_mems, _, _) = runs[True], runs[False]
    gaps = [float((a - b).abs().max()) for a, b in zip(k_mems, p_mems)]
    worst = int(np.argmax(gaps))
    scale = float(p_state.memory.abs().max())
    if name == "DyRep":  # its messages carry the attention's output
        if not gaps[worst] <= MEMORY_GAP_RTOL * scale:
            raise AssertionError(f"DyRep evaluation: memory gap {gaps[worst]} at batch {worst} > "
                                 f"{MEMORY_GAP_RTOL} x max|memory| {scale}")
    elif not all(torch.equal(getattr(k_state, f), getattr(p_state, f))
                 for f in MemoryState._fields):
        raise AssertionError(f"{name} evaluation: the final memory differs between the kernel "
                             f"and plain paths (largest gap {gaps[worst]} at batch {worst})")
    # the first batches on the port's CPU path, from the same memory
    n_cpu = 2
    cpu = LinkPredictionTrainer(tr.backbone, data, TrainConfig(batch_size=B), device="cpu")
    cpu.load_params({part: {k: v.cpu() for k, v in sd.items()}
                     for part, sd in tr.state_dicts().items()})
    _, _, cpu_probs, _ = cpu.evaluate(data.val.slice(0, n_cpu * B), cpu.val_neg,
                                      state=MemoryState(*(t.cpu() for t in start)))
    cpu_diff = max_prob_diff(k_probs[:n_cpu], cpu_probs)
    if not cpu_diff <= PROB_ATOL:
        raise AssertionError(f"{name}: card vs CPU probabilities differ by {cpu_diff}")
    result = dict(model=name, batches=MEMORY_BATCHES, launches=launches,
                  kernel_ms_per_batch=ms[True], plain_ms_per_batch=ms[False],
                  median_ms_per_batch={"kernels": statistics.median(ms[True]),
                                       "plain": statistics.median(ms[False])}, metrics=mean,
                  max_prob_diff_vs_plain=max_prob_diff(k_probs, runs[False][0]),
                  max_memory_gap_vs_plain=gaps[worst], memory_gap_batch=worst,
                  max_abs_memory=scale, max_prob_diff_vs_cpu=cpu_diff)
    log(f"  {json.dumps(result)}")
    return result


def run_memory_training(data, name, dev) -> dict:
    """Phase 5m for one memory model: the last MEMORY_TRAIN_STEPS train
    batches from the memory after the MEMORY_WARM batches before them,
    dropout 0, the same steps from the same weights in sweeps in turns
    (MEMORY_TURNS); then one lockstep step."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops

    tr = memory_trainer(data, name, dev, dropout=0.0)
    params = {part: {n: v.clone() for n, v in sd.items()} for part, sd in tr.state_dicts().items()}
    batches = tgat_train_batches(data, tr, MEMORY_TRAIN_STEPS)
    start = warm_memory(data, tr, skip_last=MEMORY_TRAIN_STEPS)
    unreached = MEMORY_UNREACHED[name]

    def sweep(use_kernels, steps=batches):
        """The steps from the seed-0 weights and the warm memory; returns
        launch counts, ms per step, losses and whether each parameter's
        gradient is finite where the loss reaches it and absent elsewhere."""
        tr.load_params(params)
        tr.optimizer = type(tr.optimizer)(
            list(tr.model.parameters()) + list(tr.head.parameters()), lr=TRAIN_LR)
        tr.model.use_kernels = use_kernels
        state, losses = start, []
        torch.cuda.synchronize()
        ops.reset_launch_counts()  # just before the sweep
        t0 = time.perf_counter()
        for arrays, bucket in steps:
            loss, _, state = tr.train_step(arrays, bucket, state)
            losses.append(loss)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / len(steps) * 1e3
        counts = {k: v for k, v in ops.launch_counts().items() if v}  # just after
        grads_ok = all(
            (p.grad is None) if n.startswith(unreached) else
            (p.grad is not None and bool(torch.isfinite(p.grad).all()))
            for n, p in tr.model.named_parameters()
        ) and all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                  for p in tr.head.parameters())
        return counts, step_ms, [float(x) for x in losses], grads_ok

    for use_kernels in (False, True):  # warm-up: allocator, cuBLAS
        sweep(use_kernels, batches[:1])
    want = {k: v * len(batches) for k, v in MEMORY_MODELS[name][1].items()}
    ms, losses_of = {True: [], False: []}, {}
    for use_kernels in MEMORY_TURNS:
        counts, step_ms, losses, grads_ok = sweep(use_kernels)
        if counts != (want if use_kernels else {}):
            raise AssertionError(f"{name} training (kernels {use_kernels}): launched {counts}, "
                                 f"expected {want if use_kernels else {}}")
        if not grads_ok or not np.isfinite(losses).all():
            raise AssertionError(f"{name} training: a loss or gradient is not finite, or a "
                                 f"parameter out of the loss's reach ({unreached}) got one")
        ms[use_kernels].append(step_ms)
        losses_of.setdefault(use_kernels, losses)
    diffs = [abs(a - b) for a, b in zip(losses_of[True], losses_of[False])]
    if not (diffs[0] <= LOSS_ATOL and max(diffs) <= LOSS_DRIFT_ATOL):
        raise AssertionError(f"{name} kernel vs plain training: losses differ by {diffs}")
    tr.model.use_kernels = True
    step = check_tgat_lockstep(tgat_lockstep(tr, params, batches[:1], 0.0, state=start),
                               name, 0.0)
    result = dict(model=name, steps=len(batches), launches=want, kernel_ms_per_step=ms[True],
                  plain_ms_per_step=ms[False],
                  median_ms_per_step={"kernels": statistics.median(ms[True]),
                                      "plain": statistics.median(ms[False])},
                  losses=losses_of[True], loss_diffs=diffs,
                  lockstep_one_step=step)
    log(f"  {json.dumps(result)}")
    return result


def run_memory_fit(name, dev) -> dict:
    """Phase 6m: fit on the JAX test fixture (K = 5, 1 layer, 2 epochs, lr
    1e-3), held to the JAX package's test AP floor. The train negatives
    come from a sampler seeded 13, as in the training phases, so that the
    run repeats (the trainer's own is unseeded, as the JAX package's)."""
    from dyglib_tpu_torch.data import synthetic_link_prediction_data
    from dyglib_tpu_torch.graph import NegativeEdgeSampler
    from dyglib_tpu_torch.models import MemoryModel, compute_src_dst_node_time_shifts
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    data = synthetic_link_prediction_data(
        num_src=120, num_dst=60, num_edges=2000, node_feat_scale=1.0, seed=7
    )
    shifts = compute_src_dst_node_time_shifts(data.train.src, data.train.dst, data.train.ts)
    save_path = os.path.join(REPO_ROOT, "dyglib_tpu_torch", "build", f"chip_smoke_{name}_fit.pkl")
    tr = LinkPredictionTrainer(
        MemoryModel(model_name=name, num_neighbors=5, num_layers=1, time_shifts=shifts), data,
        TrainConfig(batch_size=B, num_epochs=2, learning_rate=1e-3, patience=5),
        save_path=save_path, device=dev,
    )
    tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=13)
    t0 = time.perf_counter()
    res = tr.fit(seed=0, log=lambda msg: log(f"  {msg}"))
    seconds = time.perf_counter() - t0
    ap = res["test metrics"]["average_precision"]
    log(f"  {name} fixture fit: test AP {ap:.4f} (floor {MEMORY_FIT_AP_FLOOR[name]}), epoch "
        f"losses {[round(x, 4) for x in res['train losses']]}, {seconds:.1f} s")
    if not ap > MEMORY_FIT_AP_FLOOR[name]:
        raise AssertionError(f"{name} fixture fit below the floor: AP {ap}")
    return {"test_ap": ap, "train_losses": res["train losses"], "seconds": seconds}


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
            valid = arrays[6]
            out = {}
            for use_kernels in (True, False):
                path[0] = use_kernels
                acts[use_kernels] = []
                tr.model.use_kernels = use_kernels
                inputs = tr._sample(tr.train_csr, arrays, "triple", bucket)
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


def new_model_trainer(data, name, dev, dropout=None, **extra):
    """A trainer of GraphMixer, TCL or CAWN at the published widths
    (NEW_MODELS), seed-0 weights; ``dropout`` overrides the published one."""
    from dyglib_tpu_torch import models
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    kw = dict(NEW_MODELS[name], **extra)
    if dropout is not None:
        kw["dropout"] = dropout
    tr = LinkPredictionTrainer(getattr(models, name)(**kw), data,
                               TrainConfig(batch_size=B, learning_rate=TRAIN_LR), device=dev)
    tr.init_params(0)
    return tr


def cpu_twin(tr, data):
    """The port's CPU trainer of ``tr``'s backbone, holding its weights."""
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    cpu = LinkPredictionTrainer(tr.backbone, data, TrainConfig(batch_size=B), device="cpu")
    cpu.load_params({part: {k: v.cpu() for k, v in sd.items()}
                     for part, sd in tr.state_dicts().items()})
    return cpu


def check_sweep(name, probs, metrics, losses, n_batches):
    import numpy as np

    if len(probs) != n_batches or not all(
        pos.shape == neg.shape == (B,) and np.isfinite(pos).all() and np.isfinite(neg).all()
        for pos, neg in probs
    ):
        raise AssertionError(f"{name} evaluation: probabilities malformed or not finite")
    mean = {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}
    if not all(0.0 <= v <= 1.0 for v in mean.values()) or not np.isfinite(losses).all():
        raise AssertionError(f"{name} evaluation: metrics out of range {mean}")
    return mean


def timed_sweep(tr, stream, sampler, state=None):
    """(evaluate's output, ms per batch, launch counts) of one sweep, the
    counters zeroed just before and read just after."""
    import torch

    from dyglib_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = tr.evaluate(stream, sampler, state=state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(out[2]) * 1e3
    return out, ms, {k: v for k, v in ops.launch_counts().items() if v}


def spy_rows(tr):
    """Record the rows of every ``backbone.sample`` call on ``tr``; undo with
    ``del tr.backbone.sample``."""
    rows, sample = [], tr.backbone.sample

    def spy(csr, ids, ts, **kw):
        rows.append(ids.shape[0])
        return sample(csr, ids, ts, **kw)

    tr.backbone.sample = spy
    return rows


def cawn_cpu_diff(tr, data, dev) -> float:
    """CAWN's first val batch, its neighbours drawn by the card's generator,
    through the card's net and the port's CPU twin: the largest probability
    difference (the CPU's generator would draw other walks)."""
    import numpy as np
    import torch

    from dyglib_tpu_torch.data import chronological_batches
    from dyglib_tpu_torch.train import to_device

    cpu = cpu_twin(tr, data)
    b = next(iter(chronological_batches(data.val, B)))
    arrays = tr._batch_arrays(b, b.src, np.roll(b.dst, 1))
    gen = torch.Generator(device=dev).manual_seed(12345)
    with torch.inference_mode():
        inputs = tr._sample(tr.full_csr, arrays, "quad", None, gen)
        card = tr._head_loss(tr._embed(inputs, "quad"), arrays[6])[1]
        cpu_out = cpu._head_loss(cpu._embed(to_device(inputs, "cpu"), "quad"),
                                 to_device(arrays, "cpu")[6])[1]
    return max(float((torch.sigmoid(a).cpu() - torch.sigmoid(c)).abs().max())
               for a, c in zip(card, cpu_out))


def run_new_model_eval(data, name, dev) -> dict:
    """Phase 5n, evaluation: NEW_BATCHES val batches, twice (the same
    probabilities, bit for bit), no kernel launched, the first batches
    against the port's CPU path (CAWN, whose draws come from the device's
    generator: the card's sampled inputs through the CPU net)."""
    tr = new_model_trainer(data, name, dev)
    stream = data.val.slice(0, NEW_BATCHES * B)
    tr.evaluate(data.val.slice(0, B), tr.val_neg)  # warm-up: allocator, cuBLAS
    rows = spy_rows(tr)
    sweeps, ms = [], []
    for _ in range(2):
        out, batch_ms, counts = timed_sweep(tr, stream, tr.val_neg)
        if counts:
            raise AssertionError(f"{name} evaluation launched kernels: {counts}")
        mean = check_sweep(name, out[2], out[1], out[0], NEW_BATCHES)
        sweeps.append(out[2])
        ms.append(batch_ms)
    del tr.backbone.sample
    layout_rows = 4 * B if tr._layout() == "quad" else 3 * B
    if set(rows) != {layout_rows}:
        raise AssertionError(f"{name} evaluation sampled {set(rows)} rows a batch, "
                             f"not {layout_rows}")
    diff = max_prob_diff(sweeps[0], sweeps[1])
    if diff != 0.0:
        raise AssertionError(f"{name}: two evaluate sweeps differ by {diff}")
    if name == "CAWN":
        cpu_diff = cawn_cpu_diff(tr, data, dev)
    else:
        n_cpu = 2
        cpu = cpu_twin(tr, data)
        cpu_probs = cpu.evaluate(data.val.slice(0, n_cpu * B), cpu.val_neg)[2]
        cpu_diff = max_prob_diff(sweeps[0][:n_cpu], cpu_probs)
    if not cpu_diff <= PROB_ATOL:
        raise AssertionError(f"{name}: card vs CPU probabilities differ by {cpu_diff}")
    result = dict(model=name, batches=NEW_BATCHES, rows_per_batch=layout_rows,
                  ms_per_batch=ms, metrics=mean, max_prob_diff_vs_cpu=cpu_diff)
    if name == "GraphMixer":
        result["gather_vs_prefix"] = graphmixer_gather_vs_prefix(dev)
    if name == "TCL":
        result["uniform"] = run_tcl_uniform(data, dev)
    log(f"  {json.dumps(result)}")
    return result


def graphmixer_gather_vs_prefix(dev) -> float:
    """One val batch's embeddings, the node encoder's (B, time_gap, Dn)
    gather against its prefix-sum reads (they agree to ~1e-6), on the
    wikipedia-scale stream with N(0, 1) node features (the main stream's
    node features are zero, as wikipedia's are)."""
    import numpy as np
    import torch

    from dyglib_tpu_torch.data import chronological_batches, synthetic_link_prediction_data
    from dyglib_tpu_torch.models import GraphMixer

    data = synthetic_link_prediction_data(num_src=8227, num_dst=1000, num_edges=157474,
                                          node_feat_scale=1.0, seed=1)
    tr = new_model_trainer(data, "GraphMixer", dev)
    b = next(iter(chronological_batches(data.val, B)))
    arrays = tr._batch_arrays(b, b.src, np.roll(b.dst, 1))
    gather = GraphMixer(**NEW_MODELS["GraphMixer"], node_encoder_mode="gather")
    ids = torch.cat([arrays[0], arrays[1], arrays[3]])
    with torch.inference_mode():
        embs = {}
        for mode, backbone in (("prefix", tr.backbone), ("gather", gather)):
            inputs = backbone.sample(tr.full_csr, ids, arrays[4].repeat(3))
            if (inputs.tg_sum is None) != (mode == "gather"):
                raise AssertionError(f"GraphMixer {mode}: the other node encoder ran")
            if mode == "prefix" and not bool(inputs.tg_sum.abs().sum() > 0):
                raise AssertionError("GraphMixer prefix: every window sum is zero")
            embs[mode] = tr.model.eval()(tr.tables, inputs)
    diff = float((embs["prefix"] - embs["gather"]).abs().max())
    if not diff <= KERNEL_ATOL:
        raise AssertionError(f"GraphMixer gather vs prefix embeddings differ by {diff}")
    return diff


def run_tcl_uniform(data, dev) -> dict:
    """TCL under uniform sampling: the quad in every eval batch, two sweeps
    with the same probabilities."""
    tr = new_model_trainer(data, "TCL", dev, sample_strategy="uniform")
    rows = spy_rows(tr)
    stream = data.val.slice(0, NEW_BATCHES * B)
    (out1, ms1, _), (out2, ms2, _) = (timed_sweep(tr, stream, tr.val_neg) for _ in range(2))
    del tr.backbone.sample
    mean = check_sweep("TCL uniform", out1[2], out1[1], out1[0], NEW_BATCHES)
    diff = max_prob_diff(out1[2], out2[2])
    if set(rows) != {4 * B} or diff != 0.0:
        raise AssertionError(f"TCL uniform: {set(rows)} rows a batch, sweeps differ by {diff}")
    return dict(rows_per_batch=4 * B, ms_per_batch=[ms1, ms2], metrics=mean)


def run_new_model_training(data, name, dev) -> dict:
    """Phase 5n, training: NEW_TRAIN_STEPS steps on the last train batches at
    dropout 0: no kernel launched, finite losses, a finite gradient for
    every trainable parameter the loss reaches and none for the others
    (NEW_UNREACHED); ms per step (after one warm-up step)."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops

    tr = new_model_trainer(data, name, dev, dropout=0.0)
    batches = tgat_train_batches(data, tr, NEW_TRAIN_STEPS)
    tr.train_step(*batches[0])  # warm-up
    tr.init_params(0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [tr.train_step(arrays, bucket)[0] for arrays, bucket in batches]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    losses = [float(x) for x in losses]
    unreached = NEW_UNREACHED[name]
    bad = [n for n, p in tr.model.named_parameters()
           if ((p.grad is not None) if n.startswith(unreached) or not p.requires_grad else
               (p.grad is None or not bool(torch.isfinite(p.grad).all())))]
    bad += [n for n, p in tr.head.named_parameters()
            if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if counts or bad or not np.isfinite(losses).all():
        raise AssertionError(f"{name} training: launched {counts}, losses {losses}, "
                             f"gradients wrong at {bad}")
    frozen = [n for n, p in tr.model.named_parameters() if not p.requires_grad]
    result = dict(model=name, steps=len(batches), ms_per_step=step_ms, losses=losses,
                  frozen=frozen, layout=tr._layout())
    log(f"  {json.dumps(result)}")
    return result


def run_edgebank(data, dev) -> dict:
    """Phase 5n, EdgeBank: the test split under random (unlimited memory),
    historical and inductive (repeat-threshold memory) negatives, card
    against the port's CPU path: equal 0/1 probabilities, losses and
    metrics; ms per batch."""
    import numpy as np
    import torch

    from dyglib_tpu_torch.graph import build_eval_neg_samplers
    from dyglib_tpu_torch.train import edgebank_eval

    link_prediction = edgebank_eval.edge_bank_link_prediction
    recorded = []

    def spy(*args, **kw):
        out = link_prediction(*args, **kw)
        recorded.append(torch.cat(out).cpu())
        return out

    edgebank_eval.edge_bank_link_prediction = spy
    results = {}
    try:
        for strategy, mode in EDGEBANK_MODES.items():
            sampler = build_eval_neg_samplers(data, strategy)[2]
            out = []
            for device in (dev, "cpu"):
                recorded.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses, metrics = edgebank_eval.evaluate_edge_bank_link_prediction(
                    data, sampler, B, edge_bank_memory_mode=mode, device=device)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / len(losses) * 1e3
                out.append((losses, metrics, list(recorded), ms))
            (losses, metrics, probs, ms), (c_losses, c_metrics, c_probs, c_ms) = out
            same = dict(
                probabilities=len(probs) == len(c_probs) and all(
                    torch.equal(p, q) for p, q in zip(probs, c_probs)),
                losses=losses == c_losses, metrics=metrics == c_metrics)
            if not all(same.values()):
                raise AssertionError(f"EdgeBank {strategy}: card and CPU agree in {same}")
            mean = {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}
            if not all(0.0 <= v <= 1.0 for v in mean.values()):
                raise AssertionError(f"EdgeBank {strategy}: metrics out of range {mean}")
            results[strategy] = dict(memory=mode, batches=len(losses), ms_per_batch=ms,
                                     cpu_ms_per_batch=c_ms, metrics=mean)
    finally:
        edgebank_eval.edge_bank_link_prediction = link_prediction
    log(f"  {json.dumps(results)}")
    return results


def run_negatives(data, dev) -> dict:
    """Phase 5n, negatives: TGAT (default kernels) and TGN evaluate
    NEW_BATCHES val batches under historical and inductive negatives (the
    quad: 4B rows a batch; TGN from an empty memory): launches per batch as
    under random negatives, finite probabilities, the first batches
    against the port's CPU path; ms per batch."""
    from dyglib_tpu_torch.graph import build_eval_neg_samplers
    from dyglib_tpu_torch.models import TGAT
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    tgat = LinkPredictionTrainer(TGAT(num_neighbors=TGAT_K, time_feat_dim=DT_DIM), data,
                                 TrainConfig(batch_size=B), device=dev)
    tgat.init_params(0)
    trainers = {"TGAT": (tgat, TGAT_CONFIGS["default"][2]),
                "TGN": (memory_trainer(data, "TGN", dev), MEMORY_MODELS["TGN"][0])}
    stream = data.val.slice(0, NEW_BATCHES * B)
    results = {}
    for name, (tr, per_batch) in trainers.items():
        want = {k: v * NEW_BATCHES for k, v in per_batch.items()}
        for strategy in ("historical", "inductive"):
            sampler = build_eval_neg_samplers(data, strategy)[0]
            tr.evaluate(data.val.slice(0, B), sampler)  # warm-up
            rows = spy_rows(tr)
            out, ms, counts = timed_sweep(tr, stream, sampler)
            del tr.backbone.sample
            mean = check_sweep(f"{name} {strategy}", out[2], out[1], out[0], NEW_BATCHES)
            if counts != want or set(rows) != {4 * B}:
                raise AssertionError(f"{name} {strategy}: launched {counts} (expected {want}) "
                                     f"on {set(rows)} rows a batch (expected {4 * B})")
            n_cpu = 2
            cpu = cpu_twin(tr, data)
            cpu_probs = cpu.evaluate(data.val.slice(0, n_cpu * B), sampler)[2]
            cpu_diff = max_prob_diff(out[2][:n_cpu], cpu_probs)
            if not cpu_diff <= PROB_ATOL:
                raise AssertionError(f"{name} {strategy}: card vs CPU probabilities differ by "
                                     f"{cpu_diff}")
            results[f"{name} {strategy}"] = dict(launches=counts, rows_per_batch=4 * B,
                                                 ms_per_batch=ms, metrics=mean,
                                                 max_prob_diff_vs_cpu=cpu_diff)
    log(f"  {json.dumps(results)}")
    return results


def run_new_model_fit(name, dev) -> dict:
    """Phase 6n: GraphMixer, TCL and CAWN on the JAX test fixture, held to
    the JAX floors (NEW_FIT): ``fit`` for GraphMixer and CAWN; for TCL, as
    its JAX test does, four ``train_epoch``s (the last epoch's mean loss
    below 0.93 x the first's and below 0.69) and the test sweep from the
    final weights."""
    import numpy as np

    from dyglib_tpu_torch import models
    from dyglib_tpu_torch.data import synthetic_link_prediction_data
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    kw, epochs, floor = NEW_FIT[name]
    data = synthetic_link_prediction_data(
        num_src=120, num_dst=60, num_edges=2000, node_feat_scale=1.0, seed=7
    )
    save_path = os.path.join(REPO_ROOT, "dyglib_tpu_torch", "build", f"chip_smoke_{name}_fit.pkl")
    tr = LinkPredictionTrainer(
        getattr(models, name)(**kw), data,
        TrainConfig(batch_size=B, num_epochs=epochs, learning_rate=1e-3, patience=5),
        save_path=save_path, device=dev)
    t0 = time.perf_counter()
    if name == "TCL":
        tr.init_params(0)
        losses = [float(np.mean(tr.train_epoch()[0])) for _ in range(epochs)]
        ap = tr.mean_metrics(tr.evaluate(data.test, tr.test_neg, 2)[1])["average_precision"]
        ok = ap > floor and losses[-1] < 0.93 * losses[0] and losses[-1] < 0.69
    else:
        res = tr.fit(seed=0, log=lambda msg: log(f"  {msg}"))
        losses, ap = res["train losses"], res["test metrics"]["average_precision"]
        ok = ap > floor
    seconds = time.perf_counter() - t0
    log(f"  {name} fixture fit: test AP {ap:.4f} (floor {floor}), epoch losses "
        f"{[round(x, 4) for x in losses]}, {seconds:.1f} s")
    if not ok:
        raise AssertionError(f"{name} fixture fit below the floors: AP {ap}, losses {losses}")
    return {"test_ap": ap, "train_losses": losses, "seconds": seconds}


def nonzero_launches() -> dict:
    from dyglib_tpu_torch import ops

    return {k: v for k, v in ops.launch_counts().items() if v}


def nodecls_trainer(data, nc, name, dev):
    """A node-classification trainer of ``name`` at its published wikipedia
    widths, built as the CLI builds it (``get_node_classification_args`` with
    ``--load_best_configs``, ``build_backbone``), backbone weights and head
    from seed 0, head dropout 0."""
    import torch

    from dyglib_tpu_torch.configs import build_backbone, get_node_classification_args
    from dyglib_tpu_torch.train import NodeClassificationTrainer, TrainConfig

    args = get_node_classification_args(
        ["--model_name", name, "--dataset_name", "wikipedia", "--load_best_configs"])
    backbone = build_backbone(args, data)
    params = backbone.build(FEAT, FEAT, torch.Generator().manual_seed(0)).state_dict()
    tr = NodeClassificationTrainer(
        backbone, nc, TrainConfig(batch_size=B, learning_rate=TRAIN_LR, head_dropout=0.0), None,
        params, device=dev)
    tr.init_params(0)
    return tr


def recorded_probs(tr) -> list:
    """Record each ``eval_step``'s probabilities on ``tr`` as host arrays;
    undo with ``del tr.eval_step``."""
    out, step = [], tr.eval_step

    def spy(*args, **kw):
        probs, state = step(*args, **kw)
        out.append(probs.cpu().numpy())
        return probs, state

    tr.eval_step = spy
    return out


def run_nodecls_eval(data, nc, name, dev) -> tuple:
    """Phase 5c, evaluation: the first NODECLS_BATCHES val batches (a memory
    model's from the memory after the last MEMORY_WARM train batches), plain
    and kernel paths in turns (NODECLS_TURNS), counters zeroed just before
    each sweep and read just after; every sweep within PROB_ATOL of the
    first plain one, the two kernel sweeps bitwise equal, DyGFormer's card
    path within PROB_ATOL of its CPU path. Returns (trainer, results)."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.train import NodeClassificationTrainer

    tr = nodecls_trainer(data, nc, name, dev)
    state0 = None
    if tr.has_state:
        n = nc.train.num_interactions
        state0 = tr.evaluate(nc.train.slice(n - MEMORY_WARM * B, n))[1]
    stream = nc.val.slice(0, NODECLS_BATCHES * B)
    tr.evaluate(nc.val.slice(0, B), state=state0)  # warm-up
    want = {k: v * NODECLS_BATCHES for k, v in NODECLS_MODELS[name].items()}
    sweeps = []
    for use_kernels in NODECLS_TURNS:
        path = "kernels" if use_kernels else "plain"
        tr.model.use_kernels = use_kernels
        probs = recorded_probs(tr)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        metrics, _ = tr.evaluate(stream, state=state0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / NODECLS_BATCHES * 1e3
        counts = nonzero_launches()
        del tr.eval_step
        if counts != (want if use_kernels else {}):
            raise AssertionError(f"{name} node-class evaluation ({path}) launched {counts}, "
                                 f"expected {want if use_kernels else {}}")
        if len(probs) != NODECLS_BATCHES or not all(
                p.shape == (B,) and np.isfinite(p).all() for p in probs):
            raise AssertionError(f"{name} node-class evaluation: probabilities malformed")
        if not 0.0 <= metrics["roc_auc"] <= 1.0:
            raise AssertionError(f"{name} node-class val AUC out of range: {metrics}")
        sweeps.append(dict(kernels=use_kernels, probs=probs, auc=metrics["roc_auc"], ms=ms,
                           launches=counts))
    diff = lambda a, b: max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    plain = sweeps[0]["probs"]
    kernel_runs = [sw for sw in sweeps if sw["kernels"]]
    path_diff = max(diff(sw["probs"], plain) for sw in sweeps[1:])
    repeat = diff(kernel_runs[0]["probs"], kernel_runs[1]["probs"])
    if not path_diff <= PROB_ATOL or repeat != 0.0:
        raise AssertionError(f"{name} node-class: kernel vs plain probabilities differ by "
                             f"{path_diff} (limit {PROB_ATOL}); two kernel sweeps by {repeat}")
    result = dict(model=name, batches=NODECLS_BATCHES, rows_per_batch=len(tr.layout) * B,
                  launches_per_batch=NODECLS_MODELS[name],
                  launches=kernel_runs[0]["launches"],
                  ms_per_eval_batch={"kernels": [sw["ms"] for sw in kernel_runs],
                                     "plain": [sw["ms"] for sw in sweeps if not sw["kernels"]]},
                  val_auc=kernel_runs[0]["auc"], max_prob_diff=path_diff)
    if name == "DyGFormer":
        n_cpu = 2
        cpu = NodeClassificationTrainer(
            tr.backbone, nc, tr.cfg, None,
            {k: v.cpu() for k, v in tr.model.state_dict().items()}, device="cpu")
        cpu.load_head({k: v.cpu() for k, v in tr.head.state_dict().items()})
        cpu_probs = recorded_probs(cpu)
        cpu.evaluate(nc.val.slice(0, n_cpu * B))
        result["max_prob_diff_vs_cpu"] = cpu_diff = diff(kernel_runs[0]["probs"][:n_cpu],
                                                         cpu_probs)
        if not cpu_diff <= PROB_ATOL:
            raise AssertionError(f"{name} node-class: card vs CPU probabilities differ by "
                                 f"{cpu_diff}")
    return tr, result


def run_nodecls_training(tr, nc, name) -> dict:
    """Phase 5c, head training: the last NODECLS_STEPS train batches (a memory
    model's from the memory after the MEMORY_WARM batches before them), head
    dropout 0, in lockstep: at each step the plain path's loss and head
    gradients from the same head, then the kernel path's ``train_step``.
    Losses within LOSS_ATOL, head gradients within GRAD_STEP_RTOL of each
    tensor's largest entry; the kernel path's forward launches and no
    backward kernel; every backbone parameter bitwise unchanged, with no
    ``.grad``."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.data import chronological_batches

    n = nc.train.num_interactions
    state = None
    if tr.has_state:
        state = tr.evaluate(nc.train.slice(n - (MEMORY_WARM + NODECLS_STEPS) * B,
                                           n - NODECLS_STEPS * B))[1]
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    head = dict(tr.head.named_parameters())
    loss_diff, grad_err, ms = 0.0, 0.0, []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for b in chronological_batches(nc.train.slice(n - NODECLS_STEPS * B, n), B):
        arrays = tr._batch_arrays(b)
        labels = torch.from_numpy(b.label.astype(np.float32)).to(tr.device)
        tr.model.use_kernels = False
        tr.head.train()
        emb, _ = tr._src_embeddings(arrays, state)
        plain_loss, _ = tr.head_loss(emb, labels, arrays[4])
        plain_grads = torch.autograd.grad(plain_loss, list(head.values()))
        tr.model.use_kernels = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, probs, state = tr.train_step(arrays, labels, state)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if not (torch.isfinite(loss) and torch.isfinite(probs).all()):
            raise AssertionError(f"{name} head step: loss or probabilities not finite")
        loss_diff = max(loss_diff, abs(float(loss) - plain_loss.item()))
        for (k, p), g in zip(head.items(), plain_grads):
            scale = float(g.abs().max())
            err = float((p.grad - g).abs().max())
            if not err <= GRAD_STEP_RTOL * scale:
                raise AssertionError(f"{name} head step: {k} gradient differs by {err} "
                                     f"(largest entry {scale})")
            grad_err = max(grad_err, err / scale)
    counts = nonzero_launches()
    want = {k: v * NODECLS_STEPS for k, v in NODECLS_MODELS[name].items()}
    if counts != want:
        raise AssertionError(f"{name} head training launched {counts}, expected {want} "
                             "(no backward kernel)")
    if not loss_diff <= LOSS_ATOL:
        raise AssertionError(f"{name} head training: losses differ by {loss_diff}")
    changed = [k for k, v in tr.model.state_dict().items() if not torch.equal(v, before[k])]
    grads = [k for k, p in tr.model.named_parameters() if p.grad is not None]
    if changed or grads:
        raise AssertionError(f"{name} head training touched the backbone: changed {changed}, "
                             f"gradients {grads}")
    return dict(steps=NODECLS_STEPS, head_step_launches=counts, ms_per_head_step=ms,
                max_loss_diff=loss_diff, max_grad_rel_err=grad_err)


def run_nodecls_fixture_fit(dev, root) -> dict:
    """Phase 5c, the JAX slow test test_node_cls_discriminative_auc_floor:
    the 4000-edge fixture (seed 7) relabelled with numpy under seed 777
    (flagged sources carry label 1 w.p. 0.8, the others 0.02), written and
    read back through the processed layout; a random TGAT backbone (K = 10,
    1 layer, seed 0), 5 head epochs at batch 100; val AUC at least
    NODECLS_FIXTURE_AUC_FLOOR."""
    import numpy as np

    from dyglib_tpu_torch.data import (
        get_link_prediction_data,
        get_node_classification_data,
        make_synthetic_bipartite,
        write_processed,
    )
    from dyglib_tpu_torch.models import TGAT
    from dyglib_tpu_torch.train import LinkPredictionTrainer, NodeClassificationTrainer, TrainConfig

    stream, edge_feats, node_feats = make_synthetic_bipartite(
        num_src=120, num_dst=60, num_edges=4000, node_feat_scale=1.0, seed=7)
    rs = np.random.RandomState(777)
    src_ids = np.unique(stream.src)
    flagged = rs.choice(src_ids, size=max(2, len(src_ids) // 8), replace=False)
    p = np.where(np.isin(stream.src, flagged), 0.8, 0.02)
    stream.label = (rs.uniform(size=len(stream.src)) < p).astype(np.float64)
    write_processed(root, "s", stream, edge_feats, node_feats)
    link = get_link_prediction_data("s", data_root=root)
    nc = get_node_classification_data("s", data_root=root)
    backbone = TGAT(num_neighbors=10, num_layers=1)
    lp = LinkPredictionTrainer(backbone, link, TrainConfig(batch_size=100), device=dev)
    lp.init_params(0)  # a random backbone: no training
    tr = NodeClassificationTrainer(
        backbone, nc, TrainConfig(batch_size=100, num_epochs=5, learning_rate=1e-3, patience=6),
        os.path.join(root, "nc.pkl"), lp.state_dicts()["backbone"], device=dev)
    t0 = time.perf_counter()
    res = tr.fit(seed=0, log=lambda msg: log(f"  {msg}"))
    seconds = time.perf_counter() - t0
    auc = res["validate metrics"]["roc_auc"]
    log(f"  node-class fixture fit: val AUC {auc:.4f} (floor {NODECLS_FIXTURE_AUC_FLOOR}), "
        f"test AUC {res['test metrics']['roc_auc']:.4f}, {seconds:.1f} s")
    if not auc >= NODECLS_FIXTURE_AUC_FLOOR:
        raise AssertionError(f"node-class fixture fit below the floor: val AUC {auc}")
    return {"val_auc": auc, "test_auc": res["test metrics"]["roc_auc"],
            "train_losses": res["train losses"], "seconds": seconds}


def run_drivers(root) -> dict:
    """Phase 5c, the four CLI drivers (``dyglib_tpu_torch.cli.*.main``, on the
    card by default) in ``root`` as the working directory, on a
    DRIVER_EDGES-edge dataset written by ``write_synthetic_dataset``: for
    each of DRIVER_MODELS (``--load_best_configs``), link-prediction
    training (1 run, 1 epoch), evaluation under historical negatives,
    node-class training (2 epochs) and node-class evaluation; the
    artifacts in DyGLib's layout, every aggregate finite and in [0, 1],
    each driver's wall seconds."""
    import numpy as np

    from dyglib_tpu_torch.cli import (
        evaluate_link_prediction,
        evaluate_node_classification,
        train_link_prediction,
        train_node_classification,
    )
    from dyglib_tpu_torch.data import write_synthetic_dataset

    write_synthetic_dataset(os.path.join(root, "processed_data"), "synthetic",
                            num_edges=DRIVER_EDGES, node_feat_scale=1.0, seed=0)
    cwd = os.getcwd()
    os.chdir(root)
    results = {}
    try:
        for model in DRIVER_MODELS:
            base = ["--model_name", model, "--dataset_name", "synthetic", "--data_root",
                    "processed_data", "--load_best_configs", "--num_runs", "1"]
            seconds = {}
            for driver, extra in (
                (train_link_prediction, ["--num_epochs", "1"]),
                (evaluate_link_prediction, ["--negative_sample_strategy", "historical"]),
                (train_node_classification, ["--num_epochs", "2"]),
                (evaluate_node_classification, []),
            ):
                name = driver.__name__.rsplit(".", 1)[-1]
                t0 = time.perf_counter()
                aggregate = driver.main(base + extra)
                seconds[name] = time.perf_counter() - t0
                values = [mean for split in aggregate.values() for mean, _ in split.values()]
                if not values or not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in values):
                    raise AssertionError(f"{model} {name}: aggregate out of range {aggregate}")
            run = f"saved_models/{model}/synthetic/{model}_seed0/{model}_seed0"
            artifacts = [f"{run}.pkl", f"{run}_node_classification.pkl"] + [
                f"saved_results/{model}/synthetic/{r}.json"
                for r in (f"{model}_seed0", f"historical_negative_sampling_{model}_seed0",
                          f"node_classification_{model}_seed0",
                          f"evaluate_node_classification_{model}_seed0")]
            missing = [a for a in artifacts if not os.path.isfile(a)]
            logs = os.listdir(f"logs/{model}/synthetic")
            if missing or len(logs) != 4:
                raise AssertionError(f"{model} drivers: missing {missing}, logs {logs}")
            log(f"  {model} drivers: wall seconds {json.dumps(seconds)}")
            results[model] = seconds
    finally:
        os.chdir(cwd)
    return results


def run_node_classification(data, dev) -> dict:
    """Phase 5c: node classification and the CLI."""
    import tempfile

    import torch

    from dyglib_tpu_torch.data import split_node_classification_data

    t0 = time.perf_counter()
    nc = split_node_classification_data(data.full, data.edge_raw_features,
                                        data.node_raw_features)
    results = {}
    for name in NODECLS_MODELS:
        tr, result = run_nodecls_eval(data, nc, name, dev)
        result.update(run_nodecls_training(tr, nc, name))
        log(f"  {json.dumps(result)}")
        results[name] = result
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        results["fixture_fit"] = run_nodecls_fixture_fit(dev, root)
        results["drivers"] = run_drivers(root)
    results["seconds"] = time.perf_counter() - t0
    log(f"  phase 5c: {results['seconds']:.1f} s")
    return results


def scan_generators(tr) -> list:
    return [g for g in (tr.dropout_gen, tr.sample_gen, tr._eval_gen) if g is not None]


def scan_snapshot(tr):
    """Copies of the weights, the optimizer's state and the generators'
    states (``scan_restore`` puts them back in place: a captured graph keeps
    the tensors it captured)."""
    params = [p.detach().clone() for m in (tr.model, tr.head) for p in m.parameters()]
    opt = [{k: v.clone() for k, v in st.items()} for st in tr.optimizer.state.values()]
    return params, opt, [g.get_state() for g in scan_generators(tr)]


def scan_restore(tr, snap) -> None:
    import torch

    params, opt, gens = snap
    with torch.no_grad():
        for p, v in zip([p for m in (tr.model, tr.head) for p in m.parameters()], params):
            p.copy_(v)
        for st, saved in zip(tr.optimizer.state.values(), opt):
            for k, v in saved.items():
                st[k].copy_(v)
    for g, st in zip(scan_generators(tr), gens):
        g.set_state(st)


def scan_lp_trainer(data, backbone, dev):
    """A link-prediction trainer in scan mode (capturable Adam, no sequence
    buckets) with seed-0 weights and train negatives from a seeded stream."""
    from dyglib_tpu_torch.graph import NegativeEdgeSampler
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    tr = LinkPredictionTrainer(backbone, data, TrainConfig(
        batch_size=B, learning_rate=TRAIN_LR, scan_epochs=True, sequence_buckets=False),
        device=dev)
    tr.init_params(0)
    tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=13)
    return tr


def scan_run(tr, captured: bool, train_stream, eval_stream, state=None) -> dict:
    """One run from where ``scan_restore`` left ``tr``: a train epoch over
    ``train_stream`` (from ``state`` for a memory model), then an eval sweep
    over ``eval_stream`` from the state it leaves; the per-batch loop or the
    captured sweeps. The launch counters are zeroed just before."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops

    probs, batch_metrics = [], tr._batch_metrics

    def record(p, b):
        probs.append((np.array(p[0]), np.array(p[1])))
        return batch_metrics(p, b)

    tr._batch_metrics = record
    tr.train_neg.reset_random_state()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tr.graphs.reset_counts()
    t0 = time.perf_counter()
    out = (tr.train_epoch_scanned if captured else tr.train_epoch)(train_stream, state=state)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev = tr.evaluate(eval_stream, tr.val_neg, 0, state=out[2] if tr.has_state else None,
                     scanned=captured)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del tr._batch_metrics
    return dict(
        losses=list(out[0]) + list(ev[0]), probs=probs,
        params=[p.detach().clone() for m in (tr.model, tr.head) for p in m.parameters()],
        states=[out[2], ev[3]] if tr.has_state else [],
        gens=[g.get_state() for g in scan_generators(tr)],
        eager=nonzero_launches(), replay=tr.graphs.launches(), replays=tr.graphs.replays,
        train_ms=(t1 - t0) / len(out[0]) * 1e3, eval_ms=(t2 - t1) / len(ev[0]) * 1e3)


def scan_nodecls_run(tr, captured: bool, train_stream, eval_stream) -> dict:
    """``scan_run`` for a node-classification trainer (a stateless
    backbone): a head epoch, then an eval sweep."""
    import torch

    from dyglib_tpu_torch import ops

    if captured:  # the sweep's (T, B) buffer (a capture must not copy to the host)
        probs, scan = [], tr.graphs.scan

        def record_scan(*args, **kw):
            out = scan(*args, **kw)
            if args[0] == ("eval",):
                probs.extend(out[0][0].cpu().numpy())
            return out

        tr.graphs.scan = record_scan
    else:
        probs = recorded_probs(tr)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tr.graphs.reset_counts()
    t0 = time.perf_counter()
    losses, _ = (tr.train_epoch_scanned if captured else tr.train_epoch)(train_stream)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    metrics, _ = tr.evaluate(eval_stream, scanned=captured)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if captured:
        del tr.graphs.scan
    else:
        del tr.eval_step
    n_eval = -(-eval_stream.num_interactions // B)
    return dict(
        losses=list(losses) + [metrics["roc_auc"]], probs=[(p, p) for p in probs],
        params=[p.detach().clone() for p in tr.head.parameters()], states=[],
        gens=[g.get_state() for g in scan_generators(tr)],
        eager=nonzero_launches(), replay=tr.graphs.launches(), replays=tr.graphs.replays,
        train_ms=(t1 - t0) / len(losses) * 1e3, eval_ms=(t2 - t1) / n_eval * 1e3)


def scan_check(name: str, loop: dict, graph: dict) -> dict:
    """The captured run against the loop: losses, probabilities, weights
    and the memory's floats within SCAN_ATOL, its clocks and flags and the
    generators' states equal, and every kernel's loop launches equal to the
    captured run's eager (warm-up) launches plus its replays' launches,
    each kernel replayed at least once."""
    import numpy as np
    import torch

    errs = [abs(a - b) for a, b in zip(loop["losses"], graph["losses"])]
    if len(loop["probs"]) != len(graph["probs"]) or len(loop["losses"]) != len(graph["losses"]):
        raise AssertionError(f"{name}: the captured run has another number of batches")
    errs += [float(np.abs(a - c).max()) for (a, b), (c, d) in zip(loop["probs"], graph["probs"])]
    errs += [float(np.abs(b - d).max()) for (a, b), (c, d) in zip(loop["probs"], graph["probs"])]
    errs += [float((a - b).abs().max()) for a, b in zip(loop["params"], graph["params"])]
    for s0, s1 in zip(loop["states"], graph["states"]):
        for f in s0._fields:
            a, b = getattr(s0, f), getattr(s1, f)
            if a.is_floating_point():
                errs.append(float((a - b).abs().max()))
            elif not torch.equal(a, b):
                raise AssertionError(f"{name}: the memory's {f} differs after the captured run")
    err = max(errs)
    if not err <= SCAN_ATOL:
        raise AssertionError(f"{name}: captured run vs loop {err:.3g} > {SCAN_ATOL}")
    if len(loop["gens"]) != len(graph["gens"]) or not all(
            torch.equal(a, b) for a, b in zip(loop["gens"], graph["gens"])):
        raise AssertionError(f"{name}: a generator's state differs after the captured run")
    total = {k: graph["eager"].get(k, 0) + graph["replay"].get(k, 0)
             for k in set(graph["eager"]) | set(graph["replay"])}
    if total != loop["eager"] or not all(graph["replay"].get(k, 0) > 0 for k in loop["eager"]):
        raise AssertionError(f"{name}: launches, loop {loop['eager']} vs captured run's eager "
                             f"{graph['eager']} + replays {graph['replay']}")
    if graph["replays"] == 0:
        raise AssertionError(f"{name}: no graph was replayed")
    return dict(max_abs_err=err, launches=loop["eager"], warmup_launches=graph["eager"],
                replay_launches=graph["replay"], replays=graph["replays"])


def traced_kernel_launches(fn) -> tuple[dict, list]:
    """Run ``fn()`` under ``torch.profiler`` (the card's activity) -> (each
    TRACE_KERNELS kernel's launches in its trace, the distinct kernel names
    the trace holds)."""
    import re
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    counts = {k: sum(1 for n in names if re.search(pat, n))
              for k, pat in TRACE_KERNELS.items()}
    return {k: v for k, v in counts.items() if v}, sorted(set(names))


def scan_traced(name, tr, run, snap, result) -> None:
    """A captured run that only replays, under the profiler: the kernels
    the trace shows launched must be the replays' reckoning (launches a
    replay x replays) and the loop's counts. They are the printed
    ``scan_launches``."""
    scan_restore(tr, snap)
    box = {}
    traced, names = traced_kernel_launches(lambda: box.setdefault("run", run(True)))
    r = box["run"]
    if r["eager"] or traced != r["replay"] or traced != result["launches"]:
        raise AssertionError(
            f"{name}: the trace of a replayed run shows {traced}; the replays' reckoning "
            f"{r['replay']}, eager {r['eager']}, the loop {result['launches']}; kernels in "
            f"the trace: {names}")
    result["scan_launches"] = traced


def scan_compare(name, tr, run, timed: bool) -> dict:
    """The loop, then the captured run (which captures), from one snapshot
    taken after a first loop run (Adam makes its state at its first step);
    with ``timed``, SCAN_TURNS more runs for the medians of ms per train
    step and eval batch."""
    import torch

    run(False)
    snap = scan_snapshot(tr)
    runs = {}
    for captured in (False, True):
        scan_restore(tr, snap)
        runs[captured] = run(captured)
    result = scan_check(name, runs[False], runs[True])
    scan_traced(name, tr, run, snap, result)
    if timed:
        turns = {False: [], True: []}
        for captured in SCAN_TURNS:
            scan_restore(tr, snap)
            r = run(captured)
            turns[captured].append((r["train_ms"], r["eval_ms"]))
        for captured, key in ((False, "loop"), (True, "graph")):
            result[f"{key}_train_ms"] = statistics.median(t for t, _ in turns[captured])
            result[f"{key}_eval_ms"] = statistics.median(e for _, e in turns[captured])
            result[f"{key}_turns"] = turns[captured]
    log(f"  {name}: {json.dumps(result)}")
    torch.cuda.empty_cache()
    return result


def run_scan_epochs(data, dev) -> dict:
    """Phase 5s: the scan path's captured sweeps against the loop."""
    import gc

    import torch

    from dyglib_tpu_torch import models
    from dyglib_tpu_torch.data import split_node_classification_data

    t0 = time.perf_counter()
    n = data.train.num_interactions
    stream = lambda split, start, batches: split.slice(start, start + batches * B)
    train_last = stream(data.train, n - SCAN_TRAIN_BATCHES * B, SCAN_TRAIN_BATCHES)
    val = stream(data.val, 0, SCAN_EVAL_BATCHES)
    shifts = models.compute_src_dst_node_time_shifts(data.train.src, data.train.dst,
                                                     data.train.ts)
    tgat = lambda **kw: models.TGAT(num_neighbors=TGAT_K, num_layers=2, num_heads=2,
                                    time_feat_dim=DT_DIM, dropout=0.0, **kw)
    dygformer = lambda **kw: models.DyGFormer(
        max_input_sequence_length=32, patch_size=1, channel_embedding_dim=CED, num_layers=2,
        num_heads=2, time_feat_dim=DT_DIM, dropout=0.0, **kw)
    memory = lambda name: models.MemoryModel(
        model_name=name, num_neighbors=MEMORY_K, num_layers=1, num_heads=2,
        time_feat_dim=DT_DIM, dropout=0.0, time_shifts=shifts)
    new = lambda name: getattr(models, name)(**dict(NEW_MODELS[name], dropout=0.0))
    # (name, backbone, (train, eval) batches, timed in turns)
    cases = [
        ("DyGFormer", dygformer(), (SCAN_TRAIN_BATCHES, SCAN_EVAL_BATCHES), True),
        ("TGAT", tgat(), (SCAN_TRAIN_BATCHES, SCAN_EVAL_BATCHES), True),
        ("TGN", memory("TGN"), (SCAN_TRAIN_BATCHES, SCAN_EVAL_BATCHES), True),
        ("TGAT uniform", tgat(sample_strategy="uniform"), (5, 5), False),
        ("TGAT window", tgat(wants_entry_features=True), SCAN_ONE_REPLAY, False),
        ("TGAT Phi fusion", tgat(use_phi_fusion=True), SCAN_ONE_REPLAY, False),
        ("DyGFormer entry fetch", dygformer(use_entry_fetch=True), SCAN_ONE_REPLAY, False),
    ] + [(name, memory(name), SCAN_TWO_REPLAYS, False) for name in ("DyRep", "JODIE")] + [
        (name, new(name), SCAN_TWO_REPLAYS, False) for name in NEW_MODELS]
    results = {}
    for name, backbone, (n_train, n_eval), timed in cases:
        tr = scan_lp_trainer(data, backbone, dev)
        train = stream(data.train, n - n_train * B, n_train)
        state = None
        if name == "TGN":  # the memory the SCAN_TRAIN_BATCHES * 2 batches before leave
            warm = stream(data.train, n - 3 * SCAN_TRAIN_BATCHES * B, 2 * SCAN_TRAIN_BATCHES)
            state = tr.evaluate(warm, tr.train_neg, state=tr.init_state(), scanned=False)[3]
        results[name] = scan_compare(
            name, tr, lambda c: scan_run(tr, c, train, stream(data.val, 0, n_eval), state),
            timed)
        del tr
        gc.collect()
    nc = split_node_classification_data(data.full, data.edge_raw_features,
                                        data.node_raw_features)
    tr = nodecls_trainer(data, nc, "DyGFormer", dev)
    tr.cfg = dataclasses.replace(tr.cfg, scan_epochs=True)
    tr.init_params(0)  # a fresh optimizer and graphs
    train = stream(nc.train, 0, SCAN_TRAIN_BATCHES)
    results["DyGFormer node classification"] = scan_compare(
        "DyGFormer node classification", tr,
        lambda c: scan_nodecls_run(tr, c, train, stream(nc.val, 0, SCAN_EVAL_BATCHES)), True)
    del tr
    gc.collect()
    results["TGAT uniform salts"] = scan_salts(data, tgat(sample_strategy="uniform"), dev)
    results["TGAT uniform fit"] = scan_fit(dev)
    torch.cuda.empty_cache()
    results["seconds"] = time.perf_counter() - t0
    log(f"  phase 5s: {results['seconds']:.1f} s")
    return results


def scan_salts(data, backbone, dev) -> dict:
    """Eval sweeps with the salts SCAN_SALTS through one cached graph (its
    generator re-seeded a sweep) against eager sweeps with those salts:
    probabilities within SCAN_ATOL, the generator's state equal after each
    sweep, salts 0 and 2 drawing different neighbours."""
    import numpy as np
    import torch

    tr = scan_lp_trainer(data, backbone, dev)
    val = data.val.slice(0, SCAN_SALT_BATCHES * B)

    def sweep(salt, scanned):
        ev = tr.evaluate(val, tr.val_neg, salt, scanned=scanned)
        return ev[2], tr._eval_gen.get_state()

    eager = {salt: sweep(salt, False) for salt in set(SCAN_SALTS)}
    err, replays = 0.0, []
    for salt in SCAN_SALTS:
        tr.graphs.reset_counts()
        probs, gen = sweep(salt, True)
        replays.append(tr.graphs.replays)
        want, want_gen = eager[salt]
        err = max([err] + [float(np.abs(a - c).max()) for p, q in zip(probs, want)
                           for a, c in zip(p, q)])
        if not torch.equal(gen, want_gen):
            raise AssertionError(f"salt {salt}: the eval generator's state differs")
    graphs = [k for k in tr.graphs._entries if k[0] == "eval"]
    differ = max(float(np.abs(p[0] - q[0]).max()) for p, q in zip(eager[0][0], eager[2][0]))
    if not (err <= SCAN_ATOL and len(graphs) == 1 and all(replays[1:]) and differ > 0):
        raise AssertionError(f"salts through one graph: err {err}, eval graphs {graphs}, "
                             f"replays {replays}, salt 0 vs 2 {differ}")
    out = dict(max_abs_err=err, replays=replays, salt_0_vs_2=differ)
    log(f"  TGAT uniform, salts {SCAN_SALTS} through one graph: {json.dumps(out)}")
    return out


def scan_fit(dev) -> dict:
    """A 2-epoch ``fit`` with ``scan_epochs`` on the JAX test fixture (TGAT
    ``uniform``, train negatives seeded 13), whose val, new-node val, test
    and new-node test sweeps replay one cached eval graph with salts 0-3,
    against the same ``fit`` taking the loop's steps. Both keep the scan
    mode's ``capturable`` Adam, whose f32 arithmetic differs from the
    default Adam's in the last bits."""
    import tempfile

    import numpy as np
    import torch

    from dyglib_tpu_torch.data import synthetic_link_prediction_data
    from dyglib_tpu_torch.graph import NegativeEdgeSampler
    from dyglib_tpu_torch.models import TGAT
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    data = synthetic_link_prediction_data(
        num_src=120, num_dst=60, num_edges=2000, node_feat_scale=1.0, seed=7)
    res, replays = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        for scanned in (False, True):
            tr = LinkPredictionTrainer(
                TGAT(num_neighbors=10, num_layers=2, time_feat_dim=DT_DIM,
                     sample_strategy="uniform"), data,
                TrainConfig(batch_size=B, num_epochs=2, learning_rate=1e-3, patience=5,
                            scan_epochs=True),
                save_path=os.path.join(tmp, f"{scanned}.pkl"), device=dev)
            tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=13)
            if not scanned:  # the loop's train epochs and sweeps
                evaluate = tr.evaluate
                tr.train_epoch_scanned = lambda state=None, epoch=0, tr=tr: tr.train_epoch(
                    state=state, epoch=epoch)
                tr.evaluate = lambda *a, evaluate=evaluate, **kw: evaluate(
                    *a, **{**kw, "scanned": False})
            res[scanned] = tr.fit(seed=0, log=lambda msg: None)
            if not scanned and tr.graphs.replays:
                raise AssertionError("the loop's fit replayed a graph")
            replays = tr.graphs.replays
    loop, graph = res[False], res[True]
    errs = [abs(a - b) for a, b in zip(loop["train losses"], graph["train losses"])]
    for key in ("validate metrics", "new node validate metrics", "test metrics",
                "new node test metrics"):
        if set(loop[key]) != set(graph[key]):
            raise AssertionError(f"scanned fit: {key} has other keys")
        errs += [abs(loop[key][k] - graph[key][k]) for k in loop[key]]
    for part, sd in loop["params"].items():
        errs += [float((v - graph["params"][part][k]).abs().max()) for k, v in sd.items()]
    err = max(errs)
    if not (err <= SCAN_ATOL and replays > 0 and np.isfinite(loop["train losses"]).all()):
        raise AssertionError(f"scanned fit vs the loop's: {err} (replays {replays})")
    out = dict(max_abs_err=err, replays=replays,
               test_ap=graph["test metrics"]["average_precision"])
    log(f"  TGAT uniform fit, scan_epochs against the loop: {json.dumps(out)}")
    torch.cuda.empty_cache()
    return out


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



# the rank grid (phase 5d): a one-rank NCCL process group on the card and
# the (1, 1) mesh; TGAT default, DyGFormer wikipedia (32/1) and TGN at their
# published widths, published dropout, trained MESH_STEPS steps and
# evaluated MESH_BATCHES val batches with and without the mesh from the same
# weights: one rank's collectives are copies, so every loss, probability,
# parameter and memory row agrees within MESH_ATOL; then timed in turns
# ---- phase 5b: bf16 compute (compute_dtype "bfloat16")
# the kernel path against the plain bf16 path (and CAWN, which runs no
# kernel, the card against the CPU): both round the same operands to bf16
# and sum in f32 in other orders, so a product now and then lands on the
# other side of a bf16 rounding boundary and moves by a bf16 ulp; such a
# flip in a rounded channel runs on through the bf16 blocks (measured up to
# a third of the gap at DyGFormer wikipedia, NVIDIA H100 80GB HBM3, 700.00 W).
# Each path is held to half its own bf16-vs-f32 gap (the plain bf16 path's
# largest |probability difference| from the f32 path), which a path that
# computed in f32 would miss, and to BF16_PROB_ATOL at most; the kernel
# path's own gap must be at least half the plain path's (bf16 changes the
# math there too). Losses in lockstep: within half the largest bf16-vs-f32
# loss difference of the free-running train sweeps, and BF16_LOSS_ATOL at
# most.
BF16_PROB_ATOL = 1e-3
BF16_LOSS_ATOL = 1e-3
# (name, val batches, train steps)
BF16_PATHS = (("DyGFormer wikipedia", 20, 5), ("DyGFormer CanParl", 5, 3), ("TGAT", 20, 5),
              ("CAWN", 5, 3))
# each path's bf16 kernels; none of the split-TF32 variants may launch there
BF16_PATH_KERNELS = {
    "DyGFormer": (("time_channel_bf16", "patch_projection_bf16", "cooccurrence"),
                  ("time_channel_bf16_bwd", "patch_projection_bf16_bwd")),
    "TGAT": (("gathered_attention", "temporal_attention"),
             ("gathered_attention_bwd", "temporal_attention_bwd")),
    "CAWN": ((), ()),
}
SPLIT_TF32_KERNELS = ("time_channel", "time_channel_bwd", "patch_projection",
                      "patch_projection_bwd")
BF16_TURNS = ("float32", "bfloat16", "bfloat16", "float32")
BF16_SCAN_BATCHES = 10
# remat at CanParl: gradients with and without remat equal (bitwise
# expected: the recompute repeats the same operations on the same inputs);
# else within this share of each tensor's largest entry
REMAT_GRAD_RTOL = 1e-6
REMAT_STEPS = 3


def bf16_backbone(name: str, compute_dtype: str, **extra):
    """The path's backbone at the published widths, dropout 0."""
    from dyglib_tpu_torch import models

    if name.startswith("DyGFormer"):
        maxlen, patch = (32, 1) if name.endswith("wikipedia") else (2048, 64)
        return models.DyGFormer(max_input_sequence_length=maxlen, patch_size=patch,
                                channel_embedding_dim=CED, num_layers=2, num_heads=2,
                                time_feat_dim=DT_DIM, dropout=0.0, compute_dtype=compute_dtype,
                                **extra)
    if name == "TGAT":
        return models.TGAT(num_neighbors=TGAT_K, num_layers=2, num_heads=2, time_feat_dim=DT_DIM,
                           dropout=0.0, compute_dtype=compute_dtype, **extra)
    return models.CAWN(**dict(NEW_MODELS["CAWN"], dropout=0.0, compute_dtype=compute_dtype,
                              **extra))


def bf16_trainers(data, name, dev):
    """{dtype: trainer} at seed-0 weights, train negatives from a seeded
    sampler (each sweep re-seeds it)."""
    from dyglib_tpu_torch.graph import NegativeEdgeSampler
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    out = {}
    for cd in ("float32", "bfloat16"):
        tr = LinkPredictionTrainer(bf16_backbone(name, cd), data,
                                   TrainConfig(batch_size=B, learning_rate=TRAIN_LR), device=dev)
        tr.init_params(0)
        tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=17)
        out[cd] = tr
    return out


def check_bf16_launches(name, what, counts, kernels) -> None:
    missing = [k for k in kernels if counts.get(k, 0) == 0]
    split = {k: counts[k] for k in SPLIT_TF32_KERNELS if counts.get(k, 0)}
    if missing or split:
        raise AssertionError(f"{name} bf16 {what}: bf16 kernels not launched {missing}, "
                             f"split-TF32 kernels launched {split}")


def run_bf16_path(data, name, n_batches, n_steps, dev) -> dict:
    """Phase 5b for one path: evaluation and training in bf16 on the card,
    the kernel path against the plain one, the gap to f32, ms in turns."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops

    family = name.split()[0]
    fwd_kernels, bwd_kernels = BF16_PATH_KERNELS[family]
    trs = bf16_trainers(data, name, dev)
    tr = trs["bfloat16"]
    stream = data.val.slice(0, n_batches * B)
    n = data.train.num_interactions
    train_stream = data.train.slice(n - n_steps * B, n)
    has_kernels = hasattr(tr.model, "use_kernels")

    def evaluate(t, use_kernels=True, s=stream):
        if has_kernels:
            t.model.use_kernels = use_kernels
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        losses, _, probs = t.evaluate(s, t.val_neg)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / len(probs) * 1e3, probs, ops.launch_counts(), losses

    def train(t, use_kernels=True):
        t.init_params(0)
        t.train_neg.reset_random_state()
        if has_kernels:
            t.model.use_kernels = use_kernels
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [float(t.train_step(arrays, bucket)[0])
                  for _, arrays, bucket in t.train_batches(train_stream)]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / len(losses) * 1e3, losses, ops.launch_counts()

    for t in trs.values():  # warm-up: allocator, cuBLAS, the kernels' first launches
        evaluate(t, s=stream.slice(0, B))
    # the main path: counters zeroed just before, read just after
    _, probs, eval_launches, losses = evaluate(tr)
    check_bf16_launches(name, "evaluation", eval_launches, fwd_kernels)
    if not all(np.isfinite(p).all() and np.isfinite(q).all() for p, q in probs):
        raise AssertionError(f"{name} bf16: probabilities not finite")
    _, probs32, _, _ = evaluate(trs["float32"])
    gap = max_prob_diff(probs, probs32)
    if has_kernels:
        _, plain, plain_counts, _ = evaluate(tr, use_kernels=False)
        if any(plain_counts.values()):
            raise AssertionError(f"{name} bf16: the plain path launched {plain_counts}")
        plain_diff = max_prob_diff(probs, plain)
        plain_gap = max_prob_diff(plain, probs32)
    else:  # the CPU, on the card's draws of the first batch's walks
        plain_diff, plain_gap = cawn_cpu_diff(tr, data, dev), gap
    limit = min(BF16_PROB_ATOL, plain_gap / 2)
    if not plain_diff <= limit:
        raise AssertionError(f"{name} bf16: kernel vs plain probabilities differ by {plain_diff} "
                             f"> {limit} (the plain path's bf16-vs-f32 gap {plain_gap})")
    if not gap >= plain_gap / 2:
        raise AssertionError(f"{name} bf16: the kernel path's bf16-vs-f32 gap {gap} is under "
                             f"half the plain path's {plain_gap}")

    # training: the main path, then the kernel and plain paths in lockstep
    _, train_losses, train_launches = train(tr)
    check_bf16_launches(name, "training", train_launches, fwd_kernels + bwd_kernels)
    if not np.isfinite(train_losses).all():
        raise AssertionError(f"{name} bf16 training: a loss is not finite")
    # from the same weights, the same batches
    loss_gap = float(np.abs(np.subtract(train_losses, train(trs["float32"])[1])).max())
    lock_diff = bf16_lockstep(tr, train_stream) if has_kernels else None
    lock_limit = min(BF16_LOSS_ATOL, loss_gap / 2)
    if lock_diff is not None and not lock_diff <= lock_limit:
        raise AssertionError(f"{name} bf16 training in lockstep: losses differ by {lock_diff} "
                             f"> {lock_limit} (the bf16-vs-f32 loss gap {loss_gap})")

    # ms per batch and per step, f32 and bf16 in turns, after a warm-up step
    # of each (the first sweeps allocate)
    for t in trs.values():
        train(t)
    eval_ms = {cd: [] for cd in trs}
    train_ms = {cd: [] for cd in trs}
    for cd in BF16_TURNS:
        eval_ms[cd].append(evaluate(trs[cd])[0])
        train_ms[cd].append(train(trs[cd])[0])
    result = dict(
        path=name, batches=n_batches, steps=n_steps, eval_launches=eval_launches,
        train_launches=train_launches, max_prob_diff_vs_plain=plain_diff, prob_limit=limit,
        lockstep_max_loss_diff=lock_diff, lockstep_limit=lock_limit, bf16_vs_f32_prob_gap=gap,
        plain_bf16_vs_f32_prob_gap=plain_gap, bf16_vs_f32_loss_gap=loss_gap,
        eval_ms_per_batch=eval_ms, train_ms_per_step=train_ms, bf16_losses=train_losses,
    )
    log(f"  {json.dumps(result)}")
    torch.cuda.empty_cache()
    return result


def bf16_lockstep(tr, stream) -> float:
    """At every step both paths' loss from the same parameters (the kernel
    path's trajectory), then the kernel path's optimizer step: the largest
    loss difference."""
    import torch

    tr.init_params(0)
    tr.train_neg.reset_random_state()
    layout = tr._layout()
    params = [p for m in (tr.model, tr.head) for p in m.parameters()]
    tr.model.train()
    tr.head.train()
    worst = 0.0
    for _, arrays, bucket in list(tr.train_batches(stream)):
        out = {}
        for use_kernels in (True, False):
            tr.model.use_kernels = use_kernels
            inputs = tr._sample(tr.train_csr, arrays, layout, bucket)
            loss, _ = tr._head_loss(tr._embed(inputs, layout), arrays[6])
            out[use_kernels] = (float(loss.detach()), torch.autograd.grad(loss, params))
        worst = max(worst, abs(out[True][0] - out[False][0]))
        for p, g in zip(params, out[True][1]):
            p.grad = g
        tr.optimizer.step()
    tr.model.use_kernels = True
    return worst


def bf16_scan_times(data, dev) -> dict:
    """The captured scan path, f32 and bf16 in turns (DyGFormer wikipedia
    and TGAT): each bf16 capture against its loop and its replays traced
    (``scan_compare``), then ms per train step and eval batch."""
    import gc

    n = data.train.num_interactions
    train = data.train.slice(n - BF16_SCAN_BATCHES * B, n)
    val = data.val.slice(0, BF16_SCAN_BATCHES * B)
    out = {}
    for name in ("DyGFormer wikipedia", "TGAT"):
        trs = {cd: scan_lp_trainer(data, bf16_backbone(name, cd), dev)
               for cd in ("float32", "bfloat16")}
        runs = {cd: (lambda c, tr=tr: scan_run(tr, c, train, val)) for cd, tr in trs.items()}
        res = scan_compare(f"{name} bf16", trs["bfloat16"], runs["bfloat16"], timed=False)
        fwd, bwd = BF16_PATH_KERNELS[name.split()[0]]
        check_bf16_launches(name, "captured scan", res["scan_launches"], fwd + bwd)
        snaps = {"bfloat16": scan_snapshot(trs["bfloat16"])}
        tr = trs["float32"]  # its capture, from one snapshot after a first loop run
        runs["float32"](False)
        snaps["float32"] = scan_snapshot(tr)
        scan_restore(tr, snaps["float32"])
        runs["float32"](True)
        res.update(train_ms={cd: [] for cd in trs}, eval_ms={cd: [] for cd in trs})
        for cd in BF16_TURNS:
            scan_restore(trs[cd], snaps[cd])
            r = runs[cd](True)
            res["train_ms"][cd].append(r["train_ms"])
            res["eval_ms"][cd].append(r["eval_ms"])
        out[name] = res
        log(f"  {name} scan path: {json.dumps(res)}")
        del trs, runs
        gc.collect()
    return out


def run_bf16(data, dev) -> dict:
    """Phase 5b: every bf16 path, the scan path's times, remat at CanParl."""
    t0 = time.perf_counter()
    out = {name: run_bf16_path(data, name, nb, ns, dev) for name, nb, ns in BF16_PATHS}
    out["scan"] = bf16_scan_times(data, dev)
    out["remat"] = run_remat(data, dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 5b: {out['seconds']:.1f} s")
    return out


def run_remat(data, dev) -> dict:
    """DyGFormer CanParl train steps at dropout 0.1 with and without remat,
    from the same weights and dropout seed: gradients and the generator's
    state after each step equal, peak memory and ms of each; then a
    captured remat step against its loop."""
    import numpy as np
    import torch

    from dyglib_tpu_torch.graph import NegativeEdgeSampler
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    n = data.train.num_interactions
    train = data.train.slice(n - REMAT_STEPS * B, n)
    out = {}
    grads, gens, losses = {}, {}, {}
    for remat in (False, True, True, False):  # in turns; the second of each timed
        backbone = bf16_backbone("DyGFormer CanParl", "float32", remat=remat)
        backbone.dropout = 0.1
        tr = LinkPredictionTrainer(backbone, data, TrainConfig(batch_size=B,
                                   learning_rate=TRAIN_LR), device=dev)
        tr.init_params(0)
        tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=19)
        batches = [(a, bk) for _, a, bk in tr.train_batches(train)]
        tr.train_step(*batches[0])  # warm-up: allocator, cuBLAS
        tr.init_params(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        step_grads, step_gens, step_losses = [], [], []
        for arrays, bucket in batches:
            step_losses.append(float(tr.train_step(arrays, bucket)[0]))
            step_grads.append([p.grad.detach().clone() for p in tr.model.parameters()
                               if p.grad is not None])
            step_gens.append(tr.dropout_gen.get_state())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / len(batches) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) - base
        key = "remat" if remat else "no remat"
        out.setdefault(key, {"ms_per_step": [], "peak_bytes_above_weights": []})
        out[key]["ms_per_step"].append(ms)
        out[key]["peak_bytes_above_weights"].append(peak)
        grads[remat], gens[remat], losses[remat] = step_grads, step_gens, step_losses
        del tr
        torch.cuda.empty_cache()
    worst, bitwise = 0.0, True
    for step, (a, b) in enumerate(zip(grads[False], grads[True])):
        for ga, gb in zip(a, b):
            bitwise = bitwise and torch.equal(ga, gb)
            worst = max(worst, float((ga - gb).abs().max()) / max(float(ga.abs().max()), 1e-30))
        if not torch.equal(gens[False][step], gens[True][step]):
            raise AssertionError(f"remat: the dropout generator differs after step {step}")
    if not worst <= REMAT_GRAD_RTOL or losses[False] != losses[True]:
        raise AssertionError(f"remat: gradients differ by {worst} of their largest entries, "
                             f"losses {losses}")
    out.update(bitwise_gradients=bitwise, max_grad_diff=worst, losses=losses[True])

    # the scan path: a captured remat epoch against its loop, f32 and bf16
    val = data.val.slice(0, B)
    out["captured_vs_loop"] = {}
    for cd in ("float32", "bfloat16"):
        backbone = bf16_backbone("DyGFormer CanParl", cd, remat=True)
        backbone.dropout = 0.1
        tr = scan_lp_trainer(data, backbone, dev)
        scan_run(tr, False, train, val)
        snap = scan_snapshot(tr)
        runs = {}
        for captured in (False, True):
            scan_restore(tr, snap)
            runs[captured] = scan_run(tr, captured, train, val)
        loop, graph = runs[False], runs[True]
        diff = max(float((a - b).abs().max()) for a, b in zip(loop["params"], graph["params"]))
        loss_diff = float(np.abs(np.subtract(loop["losses"], graph["losses"])).max())
        gens_equal = all(torch.equal(a, b) for a, b in zip(loop["gens"], graph["gens"]))
        if not (diff <= SCAN_ATOL and loss_diff <= SCAN_ATOL and gens_equal):
            raise AssertionError(f"remat captured vs loop ({cd}): parameters {diff}, losses "
                                 f"{loss_diff}, generators equal {gens_equal}")
        out["captured_vs_loop"][cd] = dict(max_param_diff=diff, max_loss_diff=loss_diff,
                                           replays=graph["replays"])
        del tr
        torch.cuda.empty_cache()
    log(f"  remat at CanParl (dropout 0.1): {json.dumps(out)}")
    return out


MESH_MODELS = ("TGAT", "DyGFormer", "TGN")
MESH_STEPS, MESH_BATCHES, MESH_ATOL = 5, 10, 1e-6
MESH_TURNS = (False, True, True, False)
# the kernels each model's mesh path must launch (forward in evaluation,
# both directions in training)
MESH_KERNELS = {
    "TGAT": ("gathered_attention", "temporal_attention", "gathered_attention_bwd",
             "temporal_attention_bwd"),
    "DyGFormer": ("time_channel", "cooccurrence", "patch_projection", "time_channel_bwd",
                  "patch_projection_bwd"),
    "TGN": ("temporal_attention", "temporal_attention_bwd"),
}
# scan epochs under the mesh: TGAT default at dropout 0, captured against
# its loop (SCAN_ATOL)
MESH_SCAN_BATCHES = 5


def mesh_model_trainer(data, name, dev, mesh=None, scan=False, dropout=0.1):
    """A link-prediction trainer of ``name`` at its published widths, seed-0
    weights, on ``mesh`` (None: one device)."""
    from dyglib_tpu_torch.models import TGAT, DyGFormer, MemoryModel, compute_src_dst_node_time_shifts
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    if name == "TGAT":
        backbone = TGAT(num_neighbors=TGAT_K, num_layers=2, num_heads=2, time_feat_dim=DT_DIM,
                        dropout=dropout)
    elif name == "DyGFormer":
        backbone = DyGFormer(max_input_sequence_length=32, patch_size=1, time_feat_dim=DT_DIM,
                             dropout=dropout)
    else:
        shifts = compute_src_dst_node_time_shifts(data.train.src, data.train.dst, data.train.ts)
        backbone = MemoryModel(model_name="TGN", num_neighbors=MEMORY_K, num_layers=1,
                               num_heads=2, time_feat_dim=DT_DIM, dropout=dropout,
                               time_shifts=shifts)
    tr = LinkPredictionTrainer(backbone, data, TrainConfig(batch_size=B, learning_rate=TRAIN_LR,
                                                           scan_epochs=scan),
                               device=dev, mesh=mesh)
    tr.init_params(0)
    return tr


def expected_collectives(tr, name, train: bool) -> dict:
    """The collectives one step makes on a (1, 1) mesh, as the CPU tests
    reckon them (tests/test_torch_parallel_*.py): {site: (calls, bytes)}."""
    out = {"step/loss": (1, 4), "step/probs": (1, 2 * B * 4)}
    if train:  # one flat buffer of the gradients the loss reached
        n = sum(p.numel() for m in (tr.model, tr.head) for p in m.parameters()
                if p.grad is not None)
        out["train/grads"] = (1, 4 * n)
    if name == "TGN":  # memory 172 wide, messages 2 x 172 + Dt + 172
        w = 2 * FEAT + DT_DIM + FEAT
        rows = 3 * B + 3 * B * MEMORY_K + 2 * B  # hop 0, hop 1, the commit's 2B
        out["memory/ids"] = (3, 4 * rows)
        out["memory/rows"] = (3, 4 * rows * (FEAT + w + 3))
        out["memory/messages"] = (1, 4 * 2 * B * (w + 2))
    return out


def mesh_lockstep(name, plain, meshed, batches, val) -> dict:
    """Train both trainers on the same batches and evaluate both on the val
    slice: the largest difference of losses, probabilities, parameters and
    (TGN) the memory, and the mesh path's launches and collectives."""
    import numpy as np
    import torch

    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.parallel import collective_counts, reset_collective_counts

    diffs, states = {"loss": 0.0, "probs": 0.0}, [None, None]
    if plain.has_state:
        states = [plain.init_state(), meshed.init_state()]
    launches, per_step = {}, {}
    for k, (arrays, bucket) in enumerate(batches):
        outs = []
        for i, tr in enumerate((plain, meshed)):
            if tr is meshed:
                ops.reset_launch_counts()
                reset_collective_counts()
            out = tr.train_step(arrays, bucket, states[i]) if tr.has_state else \
                tr.train_step(arrays, bucket)
            if tr is meshed:
                torch.cuda.synchronize()
                for kk, v in ops.launch_counts().items():
                    launches[kk] = launches.get(kk, 0) + v
                if k == 0:
                    per_step["train"] = collective_counts()
            if tr.has_state:
                states[i] = out[2]
            outs.append(out)
        diffs["loss"] = max(diffs["loss"], abs(float(outs[0][0]) - float(outs[1][0])))
        for a, b in zip(outs[0][1], outs[1][1]):
            diffs["probs"] = max(diffs["probs"], float((a - b).abs().max()))
    diffs["params"] = max(
        float((a - b).abs().max()) for part in ("backbone", "head")
        for a, b in zip(plain.state_dicts()[part].values(), meshed.state_dicts()[part].values()))
    if plain.has_state:
        whole = meshed.host_state(states[1])
        diffs["memory"] = max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(states[0], whole))
    ops.reset_launch_counts()
    reset_collective_counts()
    ev_mesh = meshed.evaluate(val, meshed.val_neg, state=states[1])
    torch.cuda.synchronize()
    for kk, v in ops.launch_counts().items():
        launches[kk] = launches.get(kk, 0) + v
    n_eval = len(ev_mesh[2])
    per_step["eval"] = {site: (c // n_eval, b // n_eval) for site, (c, b) in
                        collective_counts().items()}
    ev_plain = plain.evaluate(val, plain.val_neg, state=states[0])
    diffs["eval_probs"] = max_prob_diff(ev_plain[2], ev_mesh[2])
    diffs["eval_loss"] = float(np.max(np.abs(np.subtract(ev_plain[0], ev_mesh[0]))))
    return diffs, {k: v for k, v in launches.items() if v}, per_step


def mesh_times(plain, meshed, batches, val) -> dict:
    """ms per train step and per eval batch, without and with the mesh, in
    MESH_TURNS (host clock around synchronized sweeps; medians)."""
    import statistics

    import torch

    times = {False: {"train": [], "eval": []}, True: {"train": [], "eval": []}}
    for use_mesh in MESH_TURNS:
        tr = meshed if use_mesh else plain
        state = tr.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for arrays, bucket in batches:
            out = tr.train_step(arrays, bucket, state) if tr.has_state else \
                tr.train_step(arrays, bucket)
            state = out[2] if tr.has_state else None
        torch.cuda.synchronize()
        times[use_mesh]["train"].append((time.perf_counter() - t0) / len(batches) * 1e3)
        t0 = time.perf_counter()
        n = len(tr.evaluate(val, tr.val_neg, state=state)[2])
        torch.cuda.synchronize()
        times[use_mesh]["eval"].append((time.perf_counter() - t0) / n * 1e3)
    return {f"{kind}_ms_{'mesh' if m else 'no_mesh'}": statistics.median(times[m][kind])
            for m in (False, True) for kind in ("train", "eval")}


def mesh_scan_check(data, dev, mesh) -> dict:
    """TGAT (dropout 0) under the mesh: ``train_epoch_scanned`` (captured
    CUDA graphs holding the NCCL collectives) against ``train_epoch`` from
    the same weights and seeded negatives."""
    import numpy as np

    from dyglib_tpu_torch.graph import NegativeEdgeSampler

    n = data.train.num_interactions
    stream = data.train.slice(n - MESH_SCAN_BATCHES * B, n)
    runs = []
    for scanned in (False, True):
        tr = mesh_model_trainer(data, "TGAT", dev, mesh, scan=True, dropout=0.0)
        tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=13)
        losses = (tr.train_epoch_scanned if scanned else tr.train_epoch)(stream)[0]
        runs.append((np.asarray(losses), tr))
    (l0, t0), (l1, t1) = runs
    param_diff = max(float((a - b).abs().max()) for part in ("backbone", "head")
                     for a, b in zip(t0.state_dicts()[part].values(),
                                     t1.state_dicts()[part].values()))
    out = {"loss_diff": float(np.max(np.abs(l0 - l1))), "param_diff": param_diff,
           "replays": t1.graphs.replays}
    if out["loss_diff"] > SCAN_ATOL or param_diff > SCAN_ATOL or not t1.graphs.replays:
        raise AssertionError(f"scan under the mesh disagrees with its loop: {out}")
    return out


def native_csr_check(data) -> dict:
    """The native CSR builder (g++ at first use) against the numpy path on
    the full stream: identical arrays; g++'s seconds and both build times."""
    import numpy as np

    from dyglib_tpu_torch import native
    from dyglib_tpu_torch.graph import csr
    from dyglib_tpu_torch.native import build_temporal_csr_native, native_available

    if not native_available():
        raise AssertionError("the native CSR builder did not build (g++ missing or failed)")
    s = data.full
    t0 = time.perf_counter()
    built = build_temporal_csr_native(s.src, s.dst, s.eid, s.ts, data.num_nodes)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = csr._entries_numpy(s, data.num_nodes)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    for a, b in zip(built, plain):
        if not np.array_equal(a, b.astype(a.dtype)):
            raise AssertionError("the native CSR differs from the numpy path")
    # g++ ran at the first CSR build of this process (phase 2's stream)
    return {"edges": int(s.num_interactions), "identical": True,
            "compile_s": native.build_seconds, "native_ms": native_ms, "numpy_ms": numpy_ms}


def two_rank_worker(rank, port, steps, out_q):
    """One of two NCCL ranks on its own card: TGAT at the published widths,
    dropout 0, ``steps`` train steps of the (2, 1) mesh; the losses."""
    import torch

    from dyglib_tpu_torch.data import synthetic_link_prediction_data
    from dyglib_tpu_torch.parallel import initialize_distributed, make_mesh, shutdown_distributed

    initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cuda")
    try:
        data = synthetic_link_prediction_data(num_src=8227, num_dst=1000, num_edges=157474,
                                              seed=1)
        dev = torch.device("cuda", rank)
        tr = mesh_model_trainer(data, "TGAT", dev, make_mesh(2), dropout=0.0)
        batches = [(a, b) for a, b in tgat_train_batches(data, tr, steps)]
        out_q.put((rank, [float(tr.train_step(a, b)[0]) for a, b in batches]))
    finally:
        shutdown_distributed()


def two_rank_run(data, dev) -> dict:
    """With two or more cards: the same TGAT steps at two NCCL ranks against
    one device (losses within the mesh tests' rtol 2e-3 / atol 2e-4)."""
    import multiprocessing as mp

    import numpy as np

    from dyglib_tpu_torch.parallel import free_port

    tr = mesh_model_trainer(data, "TGAT", dev, dropout=0.0)
    ref = [float(tr.train_step(a, b)[0]) for a, b in tgat_train_batches(data, tr, MESH_STEPS)]
    ctx = mp.get_context("spawn")
    q, port = ctx.Queue(), free_port()
    procs = [ctx.Process(target=two_rank_worker, args=(r, port, MESH_STEPS, q)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(q.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for r in (0, 1):
        if not np.allclose(got[r], ref, rtol=2e-3, atol=2e-4):
            raise AssertionError(f"two-rank losses {got[r]} (rank {r}) vs one device {ref}")
    return {"ranks": 2, "losses": got[0], "one_device": ref}


def run_distributed(data, dev) -> dict:
    """Phase 5d: the rank grid on the card (see MESH_MODELS)."""
    import torch

    from dyglib_tpu_torch.parallel import (
        free_port,
        initialize_distributed,
        make_mesh,
        shutdown_distributed,
    )

    t_phase = time.perf_counter()
    results = {"native_csr": native_csr_check(data)}
    log(f"  native CSR: {json.dumps(results['native_csr'])}")
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        import torch.distributed as dist

        if dist.get_backend() != "nccl":
            raise AssertionError(f"process group backend {dist.get_backend()}, not nccl")
        mesh = make_mesh(1, 1)
        n = data.val.num_interactions
        val = data.val.slice(0, min(n, MESH_BATCHES * B))
        for name in MESH_MODELS:
            plain = mesh_model_trainer(data, name, dev)
            meshed = mesh_model_trainer(data, name, dev, mesh)
            batches = tgat_train_batches(data, plain, MESH_STEPS)
            diffs, launches, per_step = mesh_lockstep(name, plain, meshed, batches, val)
            if max(diffs.values()) > MESH_ATOL:
                raise AssertionError(f"{name}: mesh vs one device differ: {diffs}")
            missing = [k for k in MESH_KERNELS[name] if not launches.get(k)]
            if missing:
                raise AssertionError(f"{name}: the mesh path launched no {missing}: {launches}")
            for kind in ("train", "eval"):
                want = expected_collectives(meshed, name, kind == "train")
                if per_step[kind] != want:
                    raise AssertionError(f"{name} {kind} step collectives {per_step[kind]}, "
                                         f"expected {want}")
            times = mesh_times(plain, meshed, batches, val)
            results[name] = dict(max_diff=diffs, mesh_launches=launches,
                                 collectives_per_step=per_step, **times)
            log(f"  {name}: {json.dumps(results[name])}")
            del plain, meshed
            torch.cuda.empty_cache()
        results["scan"] = mesh_scan_check(data, dev, mesh)
        log(f"  TGAT scan_epochs under the mesh: {json.dumps(results['scan'])}")
    finally:
        shutdown_distributed()
    if torch.cuda.device_count() >= 2:
        results["two_ranks"] = two_rank_run(data, dev)
        log(f"  two ranks: {json.dumps(results['two_ranks'])}")
    else:
        log(f"  two-rank run not possible on this machine: {torch.cuda.device_count()} card")
    results["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 5d: {results['seconds']:.1f} s ({card_line()})")
    return results


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
    log(f"bf16 variants vs plain bf16 versions (within {GRAD_RTOL} of sum|terms|; the bf16 "
        "patch projection's rounded output also within a bf16 ulp of its product and one of "
        f"itself; a second launch bitwise equal; {card_line()}):")
    kernel_results.update(check_bf16_kernels(dev))
    log(f"TGAT kernels vs plain versions (atol {KERNEL_ATOL}):")
    kernel_results.update(check_tgat_kernels(data, dev))
    log(f"TGAT backward kernels vs plain backwards (gradients within {GRAD_RTOL} of sum|terms|, "
        "a second launch bitwise equal):")
    kernel_results.update(check_tgat_backward_kernels(data, dev))
    log(f"TGN's temporal attention (K = {MEMORY_K}) vs plain versions (atol {KERNEL_ATOL}; "
        f"gradients within {GRAD_RTOL} of sum|terms|):")
    kernel_results.update(check_memory_attention_kernels(data, dev))

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
    log(f"memory models' evaluation path (probability tolerance {PROB_ATOL}; final memory "
        f"bitwise equal, DyRep's within {MEMORY_GAP_RTOL} of max|memory|):")
    memory_eval = {name: run_memory_eval(data, name, dev) for name in MEMORY_MODELS}
    log(f"memory models' training path ({MEMORY_TRAIN_STEPS} steps a sweep; one lockstep step "
        "as above):")
    memory_train = {name: run_memory_training(data, name, dev) for name in MEMORY_MODELS}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"GraphMixer, TCL and CAWN ({NEW_BATCHES} val batches twice, bitwise equal; CPU "
        f"path within {PROB_ATOL}; {NEW_TRAIN_STEPS} train steps at dropout 0):")
    for name in NEW_MODELS:
        run_new_model_eval(data, name, dev)
        run_new_model_training(data, name, dev)
        torch.cuda.empty_cache()
    log("EdgeBank on the test split, card against CPU:")
    run_edgebank(data, dev)
    log("historical and inductive negatives (the quad), TGAT and TGN:")
    run_negatives(data, dev)
    log(f"  phase 5n: {time.perf_counter() - t0:.1f} s")
    log("bf16 compute (kernel path vs plain bf16 path: probabilities within half the plain "
        f"path's bf16-vs-f32 gap and {BF16_PROB_ATOL}, losses in lockstep within half the loss "
        f"gap and {BF16_LOSS_ATOL}; no split-TF32 launch; captures vs loops within {SCAN_ATOL}, "
        "their replays traced; ms f32 and bf16 in "
        f"turns {list(BF16_TURNS)}) and DyGFormer's remat at CanParl ({card_line()}):")
    bf16_run = run_bf16(data, dev)
    torch.cuda.empty_cache()
    log(f"node classification and the CLI (probability tolerance {PROB_ATOL}; head steps in "
        f"lockstep: losses within {LOSS_ATOL}, gradients within {GRAD_STEP_RTOL}; fixture val "
        f"AUC floor {NODECLS_FIXTURE_AUC_FLOOR}; the four drivers for {DRIVER_MODELS}):")
    nodecls = run_node_classification(data, dev)
    torch.cuda.empty_cache()
    log(f"scan epochs as CUDA graphs (captured sweeps against the loop: within {SCAN_ATOL}, "
        "memory clocks and generator states equal, eager + replayed launches equal to the "
        f"loop's; ms in turns {['graph' if c else 'loop' for c in SCAN_TURNS]}; {card_line()}):")
    scan = run_scan_epochs(data, dev)
    log("fit on the JAX test fixture:")
    run_fit(dev)
    run_tgat_fit(dev)
    for name in MEMORY_MODELS:
        run_memory_fit(name, dev)
    for name in NEW_FIT:
        run_new_model_fit(name, dev)
    log(f"the rank grid on torch.distributed (one NCCL rank; {MESH_STEPS} train steps and "
        f"{MESH_BATCHES} val batches with and without the (1, 1) mesh within {MESH_ATOL}; "
        f"collectives per step as the CPU tests reckon them; ms in turns "
        f"{['mesh' if m else 'no mesh' for m in MESH_TURNS]}; the native CSR builder):")
    dist_run = run_distributed(data, dev)

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
        "time_channel_bf16": "dyglib_tpu/ops/pallas/time_channel.py:119",
        "time_channel_bf16_bwd": "dyglib_tpu/ops/pallas/time_channel.py:201",
        "patch_projection_bf16": "dyglib_tpu/ops/pallas/patch_projection.py:59",
        "patch_projection_bf16_bwd": "dyglib_tpu/ops/pallas/patch_projection.py:71",
    }

    def source(kernel):
        base = kernel.removesuffix("_bwd")
        if base == "time_channel_bf16":  # time_channel.cu's Bf16 product
            base = "time_channel"
        return f"dyglib_tpu_torch/csrc/{base}.cu"

    def scan_launches(kernel, config):
        """The launches the replays of phase 5s made: TGAT's window and Phi
        fusion kernels and the entry fetch in their one-replay captures,
        every other kernel in its model's captured train epoch and eval
        sweep; none at CanParl's width (not captured)."""
        base = kernel.removesuffix("_bwd")
        if base.endswith("_bf16"):  # phase 5b's traced bf16 replays (wikipedia)
            traced = bf16_run["scan"]["DyGFormer wikipedia"]["scan_launches"]
            return traced.get(kernel, 0) if config == "wikipedia" else 0
        case = {"tgn": "TGN", "wikipedia": "DyGFormer", "tgat": "TGAT"}.get(config)
        if base == "window_fetch":
            case = "DyGFormer entry fetch" if config == "wikipedia" else None
        elif base == "window_attention":
            case = "TGAT window"
        elif base == "phi_projection":
            case = "TGAT Phi fusion"
        return scan[case]["scan_launches"].get(kernel, 0) if case else 0

    def main_path_launches(kernel, config):
        """Forward kernels: the evaluation sweep; backward kernels: the
        training sweep; window_fetch: its entry-fetch training sweep; TGAT's
        kernels: the first evaluation (forward) or training (backward)
        sweep of their configuration; at TGN's shape, TGN's first kernel
        sweep (evaluation for the forward, training for the backward)."""
        if config == "tgn":
            sweep = memory_train if kernel.endswith("_bwd") else memory_eval
            return sweep["TGN"]["launches"][kernel]
        if kernel.removesuffix("_bwd").endswith("_bf16"):  # phase 5b's bf16 sweeps
            run = bf16_run[f"DyGFormer {config}"]
            return run["train_launches" if kernel.endswith("_bwd") else "eval_launches"][kernel]
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
            "source": source(kernel),
            "replaces": replaces[kernel],
            "launches": main_path_launches(kernel, config),
            # the node-classification path's launches (phase 5c: its first
            # kernel evaluation sweep, NODECLS_BATCHES batches)
            "node_classification_launches": nodecls.get(
                NODECLS_KERNEL_ROWS.get(config), {}).get("launches", {}).get(kernel, 0),
            # launches made by replays of captured graphs (phase 5s)
            "scan_launches": scan_launches(kernel, config),
            # the launches of the (1, 1) mesh path (phase 5d: its train steps
            # and val batches; 0 where the configuration is not driven there)
            "mesh_launches": dist_run.get(NODECLS_KERNEL_ROWS.get(config), {}).get(
                "mesh_launches", {}).get(kernel, 0),
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
            "library_partial": kernel.removesuffix("_bwd") in TGAT_KERNEL_CONFIG
            or kernel in ("time_channel_bf16", "time_channel_bf16_bwd",
                          "patch_projection_bf16_bwd"),
        })
        if "sibling_ms" in parts[0]:  # the bf16 variants: their split-TF32 siblings' times
            rows[-1]["split_tf32_ms"] = sum(p["sibling_ms"] for p in parts)
            rows[-1]["rounding_flips"] = sum(p["rounding_flips"] for p in parts)
        if ops_peak == PEAK_BF16_OPS:
            rows[-1]["bound_note"] = (
                f"tensor cores, one bf16 pass: {nops / 1e9:.1f} G operations, "
                f"{nops / PEAK_BF16_OPS * 1e3:.4f} ms at 989 T/s; bytes "
                f"{nbytes / PEAK_BYTES * 1e3:.4f} ms"
                + (f"; {sfu / 1e6:.1f} M cosines (and sines), {sfu / PEAK_SFU_OPS * 1e3:.4f} ms "
                   "at the SFU's 16 a clock per SM" if sfu else ""))
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
