"""Native (C++) host tier: the temporal-CSR builder.

Counterpart of ``dyglib_tpu/native/__init__.py``, with its own copy of
``csr_builder.cpp``. The source compiles once per content hash with
``g++ -O3 -shared -fPIC`` into ``build/native/`` beside the package (a
directory git ignores; a temporary name, then an atomic rename, so
concurrent builders do not collide) and loads through ctypes at first
use, never at import. Where no compiler is present, ``native_available()``
is False and ``graph/csr.py`` keeps its numpy path, which computes the
same arrays. This is host code; nothing of it runs on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csr_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_LIB: ctypes.CDLL | None = None
_TRIED = False
# seconds g++ took in this process (None: the library was already built)
build_seconds: float | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"_csr_native_{digest.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL | None:
    """Compile (once, content-addressed) and dlopen the library; None when
    there is no toolchain or the build fails."""
    global _LIB, _TRIED, build_seconds
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, timeout=120)
            build_seconds = time.perf_counter() - t0
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.build_temporal_csr.argtypes = [
            i64p, i64p, i64p, ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64,
            i64p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ]
        lib.build_temporal_csr.restype = None
        _LIB = lib
    except (OSError, subprocess.SubprocessError):
        _LIB = None  # no toolchain or a failed build: the numpy path
    return _LIB


def native_available() -> bool:
    return _load() is not None


def build_temporal_csr_native(
    src: np.ndarray, dst: np.ndarray, eid: np.ndarray, ts: np.ndarray,
    num_nodes: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None:
    """(offsets int64, nbr int32, eid int32, ts float64) flat arrays, or None
    when the library is unavailable. Per-node segments in stream order, an
    edge's src-side entry before its dst-side entry: the numpy path's
    interleave + stable argsort order."""
    lib = _load()
    if lib is None:
        return None
    e = len(src)
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    eid = np.ascontiguousarray(eid, dtype=np.int64)
    ts = np.ascontiguousarray(ts, dtype=np.float64)
    offsets = np.empty(num_nodes + 1, dtype=np.int64)
    nbr = np.empty(2 * e, dtype=np.int32)
    eid_out = np.empty(2 * e, dtype=np.int32)
    ts_out = np.empty(2 * e, dtype=np.float64)
    p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    lib.build_temporal_csr(
        p(src, ctypes.c_int64), p(dst, ctypes.c_int64), p(eid, ctypes.c_int64),
        p(ts, ctypes.c_double), ctypes.c_int64(e), ctypes.c_int64(num_nodes),
        p(offsets, ctypes.c_int64), p(nbr, ctypes.c_int32),
        p(eid_out, ctypes.c_int32), p(ts_out, ctypes.c_double),
    )
    return offsets, nbr, eid_out, ts_out
