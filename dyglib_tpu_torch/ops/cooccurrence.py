"""Per-row co-occurrence counting for DyGFormer (CUDA, ``csrc/cooccurrence.cu``).

    counts[r, i] = #{ j : q_ids[r, i] == k_ids[r, j] }   (float32)

Replaces ``dyglib_tpu/ops/pallas/cooccurrence.py::_kernel``. The port's
DyGFormer computes both its self counts (q = k) and its cross counts
(k = the partner row) with it; Lq and Lk are independent. Id 0 is not
special here: callers zero the counts at pad positions afterwards.

Bound on one H100 at the slice's shapes (B=200 eval triple; one launch of
600 rows for the self counts, one of 800 rows for the cross counts), each
id read once and each count written once, bytes against 3.35 TB/s. The
operations are those of the least work that gives the counts, a sort-based
count (sort a row's keys, then two binary searches per query:
Lk log2 Lk + 2 Lq log2 Lk compares), against the 67 T/s CUDA-core peak:
  * CanParl (L=2048): 34.4 MB -> 10.3 us; 95 M compares -> 1.4 us. Bound
    by bytes.
  * wikipedia (L=32): 0.54 MB -> 0.16 us; launch latency dominates.

What the simple design leaves on the table: it does all Lq x Lk compares
(O(L^2) per row, 62x the compares of a sort-based count at L=2048), and
one query per thread reloads each staged key from shared memory for every
query (several queries per thread would reuse it from a register).
"""
from __future__ import annotations

import torch

from . import _build

_NAME = "cooccurrence"
_ARGTYPES = [_build.P] * 3 + [_build.I] * 3 + [_build.P]


def cooccurrence_counts_plain(q_ids: torch.Tensor, k_ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a broadcast compare and a count per row."""
    return (q_ids[:, :, None] == k_ids[:, None, :]).sum(-1).to(torch.float32)


def cooccurrence_counts(q_ids: torch.Tensor, k_ids: torch.Tensor) -> torch.Tensor:
    """(R, Lq) x (R, Lk) int32 ids -> (R, Lq) float32 match counts.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if q_ids.device.type == "cpu":
        return cooccurrence_counts_plain(q_ids, k_ids)
    if q_ids.device.type != "cuda":
        raise ValueError(f"cooccurrence_counts: unsupported device {q_ids.device}")
    r, lq = q_ids.shape
    lk = k_ids.shape[1]
    dev = q_ids.device
    _build.require(q_ids, "q_ids", torch.int32, (r, lq), dev)
    _build.require(k_ids, "k_ids", torch.int32, (r, lk), dev)
    out = torch.empty((r, lq), dtype=torch.float32, device=dev)
    lib = _build.load(_NAME, "cooccurrence_forward", _ARGTYPES)
    rc = lib.cooccurrence_forward(
        q_ids.data_ptr(), k_ids.data_ptr(), out.data_ptr(), r, lq, lk,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    cooccurrence_counts.launches += 1
    return out


cooccurrence_counts.launches = 0
