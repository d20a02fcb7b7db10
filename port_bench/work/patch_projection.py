"""#3 patch projection forward (``ops.patch_projection``): the node and the
edge channel, each a call a step (patch > 1)."""
from port_bench import workmath

KIND = "kernel"
ANCHOR = r"patch_forward_kernel"
TRAILING = [r"sum_partials_kernel"]


def calls(cell):
    if cell["cfg"]["model"] != "DyGFormer" or cell["cfg"]["patch_size"] == 1:
        return []
    m, lp, patch, rows, ced, _, feat = workmath.dygformer(cell)
    k = patch * feat
    return [(2 * rows * k * ced, 4 * (m * lp * feat + k * ced + ced + rows * ced))] * 2
