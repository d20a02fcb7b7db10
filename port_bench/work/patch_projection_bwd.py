"""#3b patch projection backward (``ops.patch_projection_backward``): dW
and dbias of the node and the edge channel, each a call a train step."""
from port_bench import workmath

KIND = "kernel"
ANCHOR = r"patch_backward_kernel"
TRAILING = [r"sum_partials_kernel", r"strided_sum_kernel"]


def calls(cell):
    if (cell["cfg"]["model"] != "DyGFormer" or cell["cfg"]["patch_size"] == 1
            or cell["phase"] != "train"):
        return []
    m, lp, patch, rows, ced, _, feat = workmath.dygformer(cell)
    k = patch * feat
    return [(2 * rows * (k + 1) * ced, 4 * (m * lp * feat + rows * ced + (k + 1) * ced))] * 2
