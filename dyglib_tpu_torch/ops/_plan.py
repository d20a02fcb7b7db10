"""How the GEMM kernels split their reduction: the mma.sync kernels
(``csrc/patch_gemm.cuh``: the split-TF32 forwards of the patch projection
and the time channel, and both backwards, f32 and bf16) by ``best_plan``;
the bf16 forwards on wgmma (``csrc/wgmma.cuh``) by their own rules, next
to their wrappers.

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
