"""The co-occurrence kernel's counting by hash table, on the CPU.

The CUDA kernel (``csrc/cooccurrence.cu``) counts each row's keys into an
open-addressed table in shared memory: 64-bit slots (count << 32) | key, 0
for an empty slot, linear probing from the top bits of key * 0x9E3779B1,
TABLE_KEYS keys a table, the table's slots sized by ``table_slots``; then
each query adds the count its id finds, chunk by chunk. Rows of at most
ALL_PAIRS_MAX_LK keys compare all pairs instead. Here the table is
emulated slot by slot and held to the plain version and to the JAX
package's Pallas kernel (interpret mode) exactly: any int32 is an id,
INT32_MIN, INT32_MAX, 0 and negative ids included, one id repeated over a
row, keys over several tables, rows as short as wikipedia's (L = 32) and
shorter (the table path runs them when forced, as the crossover
measurement does). The wrapper's path and table-size helpers are tested
here too; the kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py``).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.ops.pallas.cooccurrence import cooccurrence_counts as jax_cooccurrence_counts
from dyglib_tpu_torch import ops

co = importlib.import_module("dyglib_tpu_torch.ops.cooccurrence")
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def _slot(key: int, slots: int) -> int:
    """The top log2(slots) bits of (key as uint32) * 0x9E3779B1 mod 2^32."""
    return ((key & 0xFFFFFFFF) * 0x9E3779B1 & 0xFFFFFFFF) >> (32 - slots.bit_length() + 1)


def emulated_counts(q: np.ndarray, k: np.ndarray) -> tuple[np.ndarray, int]:
    """The table path's counts for (R, Lq) and (R, Lk) int32 ids, and the
    longest probe any insert or lookup took."""
    r, lq = q.shape
    lk = k.shape[1]
    slots = co.table_slots(lk)
    out = np.zeros((r, lq), np.float32)
    longest = 0
    for row in range(r):
        for k0 in range(0, max(lk, 1), co.TABLE_KEYS):
            table = np.zeros(slots, np.uint64)
            for key in k[row, k0 : k0 + co.TABLE_KEYS].tolist():
                s, probes = _slot(key, slots), 1
                while table[s] != 0 and int(table[s]) & 0xFFFFFFFF != key & 0xFFFFFFFF:
                    s, probes = (s + 1) % slots, probes + 1
                table[s] = np.uint64(((int(table[s]) >> 32) + 1) << 32 | (key & 0xFFFFFFFF))
                longest = max(longest, probes)
            for i, key in enumerate(q[row].tolist()):
                s, probes = _slot(key, slots), 1
                while table[s] != 0 and int(table[s]) & 0xFFFFFFFF != key & 0xFFFFFFFF:
                    s, probes = (s + 1) % slots, probes + 1
                out[row, i] += float(int(table[s]) >> 32)
                longest = max(longest, probes)
    return out, longest


def _ids(rng, r, length, kind):
    if kind == "one":
        return np.full((r, length), 7, np.int32)
    if kind == "distinct":
        return np.stack([rng.permutation(length) for _ in range(r)]).astype(np.int32) * 97 - 5
    if kind == "extremes":
        pool = np.array([INT32_MIN, INT32_MAX, 0, -1, 1, INT32_MIN + 1, INT32_MAX - 1], np.int32)
        return rng.choice(pool, size=(r, length)).astype(np.int32)
    ids = rng.randint(1, 50, size=(r, length)).astype(np.int32)
    ids[:, length // 2 :] = 0  # DyGFormer's pads, counted like any id
    return ids


# (seed, R, Lq, Lk, kind): one id over L = 2048, all ids distinct, the
# extremes of int32 with 0 and negatives, pads; Lk over two and three
# tables; short rows in the smallest table (64 slots) and at the edges of
# the next sizes: wikipedia's L = 32, one and two keys
CASES = [
    (0, 2, 2048, 2048, "one"),
    (1, 2, 2048, 2048, "distinct"),
    (2, 3, 100, 300, "extremes"),
    (3, 2, 64, 4097, "pads"),
    (4, 1, 33, 5000, "distinct"),
    (5, 2, 70, 65, "pads"),
    (7, 4, 32, 32, "pads"),
    (8, 3, 32, 32, "one"),
    (9, 3, 5, 1, "extremes"),
    (10, 2, 40, 33, "distinct"),
    (11, 2, 64, 64, "extremes"),
    (12, 2, 7, 2, "one"),
]


@pytest.mark.parametrize("seed,r,lq,lk,kind", CASES)
def test_table_counts_equal_plain_and_jax(seed, r, lq, lk, kind):
    rng = np.random.RandomState(seed)
    k = _ids(rng, r, lk, kind)
    q = np.concatenate([k[:, :lq], _ids(rng, r, lq, kind)[:, : max(0, lq - lk)]], 1)[:, :lq]
    got, longest = emulated_counts(q, k)
    plain = ops.cooccurrence_counts_plain(torch.from_numpy(q), torch.from_numpy(k)).numpy()
    jx = np.asarray(jax_cooccurrence_counts(jnp.asarray(q), jnp.asarray(k), interpret=True))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jx)
    assert longest <= co.table_slots(lk) // 2 + 1  # a table at most half full


def test_table_probes_stay_short_on_the_main_paths_ids():
    """Ids as DyGFormer gives them (node ids up to 10,000, half of each row
    pads): the longest probe over 2048-key rows stays a few slots."""
    rng = np.random.RandomState(6)
    k = rng.randint(1, 10_000, size=(2, 2048)).astype(np.int32)
    k[:, 1024:] = 0
    _, longest = emulated_counts(k, k)
    assert longest <= 16


@pytest.mark.parametrize("lk,pairs", [(0, True), (1, True), (32, True),
                                      (co.ALL_PAIRS_MAX_LK, True),
                                      (co.ALL_PAIRS_MAX_LK + 1, False), (2048, False)])
def test_all_pairs_takes_the_short_rows(lk, pairs):
    assert co.all_pairs(lk) is pairs


@pytest.mark.parametrize("lk,slots", [(0, 64), (1, 64), (32, 64), (33, 128), (65, 256),
                                      (1024, 2048), (2047, 4096), (2048, 4096),
                                      (2049, 4096), (20_000, 4096)])
def test_table_slots_hold_twice_the_keys_of_one_table(lk, slots):
    got = co.table_slots(lk)
    assert got == slots
    assert got & (got - 1) == 0 and got >= 2 * min(lk, co.TABLE_KEYS)
    assert 8 * got <= 48 * 1024  # static shared-memory limit, no opt-in
