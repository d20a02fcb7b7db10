"""#1b time channel backward (``ops.time_channel_backward``): dW, dbias
and the time encoder's dw, db, one call a train step."""
from port_bench import workmath

KIND = "kernel"
ANCHOR = r"time_bwd_kernel<\d+, true, \d+, .*SplitTf32"
TRAILING = [r"sum_partials_kernel", r"strided_sum_kernel"]


def calls(cell):
    if cell["cfg"]["model"] != "DyGFormer" or cell["phase"] != "train":
        return []
    m, lp, patch, rows, ced, dt, _ = workmath.dygformer(cell)
    k = patch * dt
    nbytes = (4 * m * lp + m * lp + 4 * (2 * dt + k * ced + rows * ced)
              + 4 * (k * ced + ced + 2 * dt))
    return [(4 * rows * k * ced, nbytes)]
