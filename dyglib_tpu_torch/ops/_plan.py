"""How the GEMM kernels split their reduction: the mma.sync kernels
(``csrc/patch_gemm.cuh``: the split-TF32 forwards of the patch projection
and the time channel, and both backwards, f32 and bf16) by ``best_plan``;
the bf16 forwards on wgmma (``csrc/wgmma.cuh``) by their own rules, next
to their wrappers; the attention kernels' per-head products
(``csrc/head_gemm.cuh``) by ``head_plan``.

Their blocks own TILE_N columns (ced padded to n8 fragments) and stream
stages (TILE_K deep, or WGMMA_STAGE_K) through a ring of STAGES; a
reduction deeper than fills the card is split into partial sums that a
second pass adds in a fixed order.
"""
from __future__ import annotations

import functools

import torch

# csrc/patch_gemm.cuh: a block's columns, the depth of one stage, the
# stages of the ring
TILE_N, TILE_K, STAGES = 56, 32, 4
# csrc/wgmma.cuh: the depth of one stage of the wgmma kernels' rings (64
# bf16 values, one 128-byte swizzled row; their rings are STAGES deep too)
WGMMA_STAGE_K = 64
_GRID_Z_LIMIT = 65535
H100_SMS = 132
# csrc/head_gemm.cuh: the rows a block of a per-head product takes (its
# four warps 4, 2 or 1 along the rows, the others splitting each stage's
# depth), its columns (head_project's, and head_combine's and
# head_weight_grad's), and the blocks an SM holds at once (registers bound
# them to two)
HEAD_TILE_MS = (128, 64, 32)
HEAD_PROJECT_N, HEAD_TILE_N = 56, 72
HEAD_SM_BLOCKS = 2
# what a block's time grows by for each warp that splits a stage's depth
# with the first (their hand-over, and shorter runs of products between
# barriers)
HEAD_SPLIT_COST = 0.2
# the fewest rows of a weight-gradient chunk: four stages, so that the
# ring's fill and the partial sums' traffic do not outweigh a chunk's work
HEAD_MIN_CHUNK = 4 * TILE_K


@functools.lru_cache(maxsize=256)
def best_plan(out_rows: int, cols: int, depth: int, partial_floats: int, sms: int,
              tile_ms: tuple[int, ...]) -> tuple[int, int]:
    """(block rows of ``tile_ms``, stages per split) for a product of
    ``out_rows`` x ``cols`` outputs reduced over ``depth`` stages: the plan
    that least loads the busiest SM.

    A unit is one block's share of one split: ``per`` stages plus the
    ring's fill of STAGES - 1, each staging (rows + TILE_N) x TILE_K
    floats; an SM runs ceil(units / sms) of them. With more than one split,
    every split writes ``partial_floats`` partial sums that the second
    pass reads back, spread over the card. Ties go to larger blocks, then
    to fewer splits.
    """
    best = None
    for tile_m in tile_ms:
        out_tiles = -(-out_rows // tile_m) * -(-cols // TILE_N)
        for splits in range(1, min(depth, _GRID_Z_LIMIT) + 1):
            per = -(-depth // splits)
            if -(-depth // per) != splits:  # the same split as a smaller count
                continue
            units_per_sm = -(-(out_tiles * splits) // sms)
            cost = units_per_sm * (per + STAGES - 1) * (tile_m + TILE_N) * TILE_K * 4
            if splits > 1:
                cost += 8 * partial_floats * splits / sms
            if best is None or cost < best[0]:
                best = (cost, tile_m, per)
    return best[1], best[2]


@functools.lru_cache(maxsize=16)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def head_rows(rows: int, cols: int, tile_n: int, groups: int, sms: int) -> int:
    """The rows a block of a per-head product takes for ``groups`` outputs
    of ``rows`` x ``cols`` in blocks ``tile_n`` wide: the tile of
    HEAD_TILE_MS that least loads the busiest SM, counting the rounds of
    HEAD_SM_BLOCKS blocks an SM runs, a block's time as its rows, and
    HEAD_SPLIT_COST for each warp that splits its depth. Ties go to larger
    blocks."""
    def cost(tile_m):
        blocks = -(-rows // tile_m) * -(-cols // tile_n) * groups
        split = HEAD_TILE_MS[0] // tile_m - 1
        return -(-blocks // (HEAD_SM_BLOCKS * sms)) * tile_m * (1 + HEAD_SPLIT_COST * split)

    return min(HEAD_TILE_MS, key=lambda t: (cost(t), -t))


@functools.lru_cache(maxsize=256)
def head_plan(m: int, kv_dim: int, dq: int, heads: int, sms: int,
              backward: bool) -> tuple[int, ...]:
    """The plan of the attention kernels' per-head products over ``m``
    queries (``csrc/head_gemm.cuh``), a function of the shapes and the
    card's SM count alone: (head_project's rows, head_combine's rows), and
    for the backward also head_weight_grad's rows and its chunk rows.

    head_project runs over a (M, Dkv) output per head (the backward's two
    at once), head_combine over (M, Dq / heads), each in ``head_rows``'
    blocks. head_weight_grad's rows tile Dkv with the least padding (ties
    to the larger); its rows of M are cut into chunks that give the card's
    block slots (HEAD_SM_BLOCKS an SM) two rounds, each a whole number of
    TILE_K-deep stages and at least HEAD_MIN_CHUNK rows, and at most
    65535 / heads of them (its grid's z runs over chunk and head).
    """
    hd = dq // heads
    project = head_rows(m, kv_dim, HEAD_PROJECT_N, (2 if backward else 1) * heads, sms)
    combine = head_rows(m, hd, HEAD_TILE_N, heads, sms)
    if not backward:
        return project, combine
    grad = min(HEAD_TILE_MS, key=lambda t: (-(-kv_dim // t) * t, -t))
    blocks = -(-kv_dim // grad) * -(-hd // HEAD_TILE_N) * heads  # a chunk's
    chunks = max(1, -(-2 * HEAD_SM_BLOCKS * sms // blocks))
    least = max(-(-m // chunks), -(-m // (_GRID_Z_LIMIT // heads)), HEAD_MIN_CHUNK)
    return project, combine, grad, -(-least // TILE_K) * TILE_K
