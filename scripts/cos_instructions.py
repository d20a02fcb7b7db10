#!/usr/bin/env python3
"""Instructions per cosine of csrc/cos_reduced.cuh, counted in the SASS that
nvcc emits for sm_90a, and the floor they put under the kernels that
compute Phi on the CUDA cores.

    python3 scripts/cos_instructions.py [--cosines N ...]

Builds small kernels from the repo's ``cos_reduced.cuh`` (nvcc -cubin,
the port's flags), each loading 8 arguments a thread, computing, and
storing the results: ``copy`` and ``copy2`` (no cosine: the loads, one or
two stores a value, the indexing), ``cos_small`` (cosf's fast path, |x| <
105615), ``cos_large`` (the double reduction above it), ``sincos_small``
and ``sincos_large`` (cos and -sin from one reduction, the backwards'
pairs) and ``cos_reduced`` (the warp-wide choice of paths, as the
forwards call it: all its code, not one path's). ``cuobjdump -sass``
gives each kernel's instructions; (kernel - copy) / 8 is the cost of one
cosine (or pair) on its path, with its double-precision instructions
counted apart (the H100 runs them at half the f32 rate). The floor of N
cosines at the CUDA cores' instruction rate: N x instructions / (132 SMs x 4
schedulers x 32 lanes x 1.98 GHz); ``--cosines`` prints it for each N
given (default: DyGFormer CanParl's 98.3 M and wikipedia's 1.5 M valid
(position, feature) pairs, chip_smoke.py's inputs; TGAT's Phi
projection's 1.2 M and 24 M). ``--time N`` also measures, on the card,
the time of N Phi elements as the bf16 forward computes them (theta,
cos_small, the bf16 pack) in a kernel that does nothing else, with 8
blocks of 256 threads an SM (full occupancy) and, with ``--blocks-per-sm``,
fewer (2: the 16 warps an SM of the bf16 time forward's consumers); CUDA
events, median of 5: the rate the cosine itself allows. Needs nvcc and cuobjdump (CUDA_HOME or
/usr/local/cuda), and torch with a card for ``--time``; prints one JSON
object.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "dyglib_tpu_torch" / "csrc"
INSTRUCTION_RATE = 132 * 4 * 32 * 1.98e9  # thread-instructions a second, H100 SXM boost

SOURCE = r"""
#include "cos_reduced.cuh"
#define KERNEL(name, body)                                                        \
  extern "C" __global__ void name(const float* __restrict__ x, float* __restrict__ y) { \
    float a[8], c[8];                                                             \
    _Pragma("unroll") for (int i = 0; i < 8; ++i) a[i] = x[threadIdx.x + 256 * i]; \
    body;                                                                         \
    _Pragma("unroll") for (int i = 0; i < 8; ++i) y[threadIdx.x + 256 * i] = c[i]; \
  }
#define KERNEL2(name, body)                                                       \
  extern "C" __global__ void name(const float* __restrict__ x, float* __restrict__ y) { \
    float a[8], c[8], s[8];                                                       \
    _Pragma("unroll") for (int i = 0; i < 8; ++i) a[i] = x[threadIdx.x + 256 * i]; \
    body;                                                                         \
    _Pragma("unroll") for (int i = 0; i < 8; ++i) {                               \
      y[threadIdx.x + 256 * i] = c[i];                                            \
      y[threadIdx.x + 256 * (i + 8)] = s[i];                                      \
    }                                                                             \
  }
KERNEL(copy, _Pragma("unroll") for (int i = 0; i < 8; ++i) c[i] = a[i])
KERNEL2(copy2, _Pragma("unroll") for (int i = 0; i < 8; ++i) c[i] = s[i] = a[i])
KERNEL2(sincos_small,
        _Pragma("unroll") for (int i = 0; i < 8; ++i) dyglib::sincos_small(a[i], c[i], s[i]))
KERNEL2(sincos_large,
        _Pragma("unroll") for (int i = 0; i < 8; ++i) dyglib::sincos_large(a[i], c[i], s[i]))
KERNEL(cos_small, _Pragma("unroll") for (int i = 0; i < 8; ++i) c[i] = dyglib::cos_small(a[i]))
KERNEL(cos_large, _Pragma("unroll") for (int i = 0; i < 8; ++i) c[i] = dyglib::cos_large(a[i]))
KERNEL(cos_reduced, dyglib::cos_reduced<8>(a, c))
"""
# Phi elements with nothing else to do: each thread walks its own dt over
# `per_thread` features, 8 a step, and folds the packed bf16 pairs into one
# word it stores (so nothing is optimised away and nothing else is moved)
RATE_SOURCE = r"""
#include "bf16_mma.cuh"
#include "cos_reduced.cuh"
#include "phi.cuh"
__global__ void __launch_bounds__(256) phi_rate(float dt0, float tw, float tb, int per_thread,
                                                unsigned* out) {
  const int id = blockIdx.x * 256 + threadIdx.x;
  const float dt = dt0 + static_cast<float>(id % 4096);
  unsigned h = 0;
  for (int i = 0; i < per_thread; i += 8) {
    float c[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      c[e] = dyglib::cos_small(dyglib::theta_of(dt, tw * (1.f + 1e-3f * e), tb + i));
#pragma unroll
    for (int e = 0; e < 8; e += 2) h ^= dyglib::bf16::pack(c[e], c[e + 1]);
  }
  out[id] = h;
}
extern "C" int run(float dt0, float tw, float tb, int per_thread, unsigned* out, int blocks,
                   cudaStream_t stream) {
  phi_rate<<<blocks, 256, 0, stream>>>(dt0, tw, tb, per_thread, out);
  return static_cast<int>(cudaGetLastError());
}
"""
# double-precision SASS opcodes (and conversions to or from double)
DOUBLE = re.compile(r"^(DADD|DFMA|DMUL|DSETP|F2F\.F64|F2F\.F32\.F64|I2F\.F64|F2I\.F64|DMNMX)")


def cuda_bin(tool: str) -> str:
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / tool)


def sass_counts(cubin: Path) -> dict:
    """Per kernel: [instructions, double-precision instructions], NOPs
    excluded (each kernel's closing branch-to-self cancels in the
    difference with ``copy``)."""
    text = subprocess.run([cuda_bin("cuobjdump"), "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            counts[name] = [0, 0]
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None and not m.group(1).startswith("NOP"):
            counts[name][0] += 1
            counts[name][1] += bool(DOUBLE.match(m.group(1)))
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cosines", type=float, nargs="*",
                    default=[98.304e6, 1.536e6, 1.2e6, 24e6])
    ap.add_argument("--time", type=float, help="Phi elements to time on the card")
    ap.add_argument("--blocks-per-sm", type=int, nargs="*", default=[8])
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        src, cubin = Path(tmp) / "cos.cu", Path(tmp) / "cos.cubin"
        src.write_text(SOURCE)
        subprocess.run([cuda_bin("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-cubin", "-I", str(CSRC), "-o", str(cubin),
                        str(src)], check=True)
        counts = sass_counts(cubin)
    per = {k: {"instructions": (n - counts["copy2" if "sincos" in k else "copy"][0]) / 8,
               "double": d / 8}
           for k, (n, d) in counts.items() if not k.startswith("copy")}
    floors = {f"{n / 1e6:g} M cosines": {k: n * v["instructions"] / INSTRUCTION_RATE * 1e3
                                         for k, v in per.items()} for n in args.cosines}
    result = {"sass_instructions": counts, "per_cosine": per, "floor_ms_at_instruction_rate": floors}
    if args.time:
        result["measured"] = {f"{b} blocks an SM": time_phi(args.time, b)
                              for b in args.blocks_per_sm}
    print(json.dumps(result), flush=True)
    return 0


def time_phi(n: float, blocks_per_sm: int) -> dict:
    """ms for n Phi elements (theta, cos_small, pack), blocks_per_sm blocks
    of 256 threads an SM."""
    import ctypes
    import statistics

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "rate.cu", Path(tmp) / "librate.so"
        src.write_text(RATE_SOURCE)
        subprocess.run([cuda_bin("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC),
                        "-o", str(lib_path), str(src)], check=True)
        lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_void_p]
    dev = torch.device("cuda:0")
    blocks = blocks_per_sm * torch.cuda.get_device_properties(dev).multi_processor_count
    per_thread = max(8, int(n / (blocks * 256)) // 8 * 8)
    out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    go = lambda: lib.run(1000.0, 0.5, 0.1, per_thread, out.data_ptr(),
                         blocks, stream)
    if go() != 0:
        raise RuntimeError("phi_rate launch failed")
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        go()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    elements = blocks * 256 * per_thread
    return {"elements": elements, "ms": statistics.median(times),
            "ms_per_98_3M": statistics.median(times) * 98.304e6 / elements}


if __name__ == "__main__":
    sys.exit(main())
