"""Per-row co-occurrence counting for DyGFormer (CUDA, ``csrc/cooccurrence.cu``).

    counts[r, i] = #{ j : q_ids[r, i] == k_ids[r, j] }   (float32)

Replaces ``dyglib_tpu/ops/pallas/cooccurrence.py::_kernel``. The port's
DyGFormer computes both its self counts (q = k) and its cross counts
(k = the partner row) with it; Lq and Lk are independent. Id 0 is not
special here: callers zero the counts at pad positions afterwards.

Bound on one H100 at the slice's shapes (B=200 eval triple; one launch of
600 rows for the self counts, one of 800 rows for the cross counts), each
id read once and each count written once, bytes against 3.35 TB/s. The
operations are those of a sort-based count (sort a row's keys, then two
binary searches per query: Lk log2 Lk + 2 Lq log2 Lk compares), against
the 67 T/s CUDA-core peak:
  * CanParl (L=2048): 34.4 MB -> 10.3 us; 95 M compares -> 1.4 us. Bound
    by bytes.
  * wikipedia (L=32): 0.54 MB -> 0.16 us; launch latency dominates.

The design (``csrc/cooccurrence.cu``): the TPU kernel's all-pairs compare,
Lq x Lk a row, suits a vector unit, not a GPU. Long rows count each row's
keys into a hash table in shared memory (TABLE_KEYS keys at a time, its
slots sized by ``table_slots``), then every query reads its count: O(Lk +
Lq) a row. Rows whose Lk is at most ALL_PAIRS_MAX_LK take a warp each and
the all-pairs compare (``all_pairs``), which measured faster there (the
crossover, PERF.md). Counts are integers, so the result equals the plain
version exactly on either path.
"""
from __future__ import annotations

import torch

from . import _build

_NAME = "cooccurrence"
_ARGTYPES = [_build.P] * 3 + [_build.I] * 5 + [_build.P]
# csrc/cooccurrence.cu: keys of one hash table (kTableKeys); the longest
# key row that takes the all-pairs path (the measured crossover)
TABLE_KEYS = 2048
ALL_PAIRS_MAX_LK = 64
_MIN_SLOTS = 64


def all_pairs(lk: int) -> bool:
    """Whether rows of ``lk`` keys take the warp-per-row all-pairs path
    (else the hash-table path)."""
    return lk <= ALL_PAIRS_MAX_LK


def table_slots(lk: int) -> int:
    """Slots of the hash table for rows of ``lk`` keys: the least power of
    two that is at least twice the keys one table holds, and at least
    64."""
    return max(_MIN_SLOTS, 1 << (2 * min(lk, TABLE_KEYS) - 1).bit_length())


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
    if lk >= 2**24:
        raise ValueError(f"Lk = {lk}: counts from 2^24 keys are not exact in float32")
    out = torch.empty((r, lq), dtype=torch.float32, device=dev)
    lib = _build.load(_NAME, "cooccurrence_forward", _ARGTYPES)
    rc = lib.cooccurrence_forward(
        q_ids.data_ptr(), k_ids.data_ptr(), out.data_ptr(), r, lq, lk, int(all_pairs(lk)),
        table_slots(lk), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    cooccurrence_counts.launches += 1
    return out


cooccurrence_counts.launches = 0
