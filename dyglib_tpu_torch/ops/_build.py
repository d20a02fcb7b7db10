"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each ``csrc/<name>.cu`` compiles on its own, with a plain C interface and
no PyTorch headers, into ``build/lib<name>-<hash>.so`` beside the package
(a directory git ignores). The hash covers the source, the shared headers
and the nvcc flags, so an edited kernel or a changed flag rebuilds and a
current library is reused.
``build`` starts one nvcc per missing library, all at once, and waits for
all of them. Nothing is compiled or loaded when a module is imported: the
first launch builds what it needs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
KERNEL_SOURCES = (
    "time_channel", "cooccurrence", "patch_projection", "window_fetch",
    "temporal_attention", "gathered_attention", "window_attention", "phi_projection",
    "patch_projection_bf16",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
_declared: set[tuple[str, str]] = set()
_lock = threading.Lock()
# output rows of one GEMM tile (csrc/tiled_gemm.cuh kBM): per-tile scratch
# that a wrapper allocates is sized by it
TILE_ROWS = 64
# blocks that fill one H100 (132 SMs, ~8 resident 256-thread blocks each)
_FULL_CARD_BLOCKS = 8 * 132


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=KERNEL_SOURCES, ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile every library of ``names`` that is missing, in parallel.

    Returns nvcc's output per compiled source (register and shared-memory
    use with ``ptxas_verbose``); raises with the log if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_verbose else ()),
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, errors = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        logs[name] = log
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return logs


def load(name: str, entry: str, argtypes: list) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if missing), with the C
    entry point ``entry`` declared as ``int entry(argtypes...)``. Every
    entry point of a library is declared on its own first ``load``:
    undeclared, ctypes would pass each pointer as a 32-bit int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            lib.dyglib_error_string.argtypes = [ctypes.c_int]
            lib.dyglib_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        if (name, entry) not in _declared:
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _declared.add((name, entry))
    return lib


def weight_grad_chunk_rows(rows: int, k_total: int, n: int) -> int:
    """Rows per partial sum of a weight gradient (csrc/weight_grad.cuh):
    enough row chunks that its first pass fills the card, each a whole
    number of tiles, and at most 65535 chunks (the grid's z limit)."""
    tiles = -(-(k_total + 1) // TILE_ROWS) * -(-n // TILE_ROWS)
    chunks = max(1, -(-_FULL_CARD_BLOCKS // tiles))
    chunk = -(-max(1, -(-rows // chunks)) // TILE_ROWS) * TILE_ROWS
    return max(chunk, -(-rows // 65535))


class LaunchCounter:
    """The launch counts of a kernel variant that has no wrapper of its own
    (one picked by an argument of another's wrapper), for ``count_launch``."""

    def __init__(self):
        self.launches = self.captured = 0


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: ``wrapper.launches`` when it runs
    now, ``wrapper.captured`` when a CUDA graph capture records it (it then
    runs at each replay of that graph, which calls no Python)."""
    import torch

    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.dyglib_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def require(t, name: str, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` whose element count fits the kernels' int32 indices."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= 2**31:
        raise ValueError(f"{name} has {t.numel()} elements; the kernels index with int32")


def require_weight(w, name: str, dtype, shape: tuple, device) -> tuple[int, int]:
    """Like ``require`` for a (K, N) weight that is row-major or the
    transpose of a row-major (N, K) one, as ``nn.Linear.weight.t()`` is;
    returns its element strides along K and N for the kernel."""
    if tuple(w.shape) == tuple(shape) and not w.is_contiguous():
        if not w.t().is_contiguous():
            raise ValueError(f"{name} must be contiguous or the transpose of a contiguous tensor")
        require(w.t(), name, dtype, shape[::-1], device)
    else:
        require(w, name, dtype, shape, device)
    return w.stride(0), w.stride(1)


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
