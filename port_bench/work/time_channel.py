"""#1 time channel forward (``ops.time_channel_projection``): cos(dt w + b)
zeroed at padding, cut into patches and projected, one call a step."""
from port_bench import workmath

KIND = "kernel"
ANCHOR = r"time_channel_fwd_kernel<.*SplitTf32"
TRAILING = [r"sum_partials_kernel"]


def calls(cell):
    if cell["cfg"]["model"] != "DyGFormer":
        return []
    m, lp, patch, rows, ced, dt, _ = workmath.dygformer(cell)
    k = patch * dt
    nbytes = 4 * m * lp + m * lp + 4 * (2 * dt + k * ced + ced + rows * ced)
    return [(2 * rows * k * ced, nbytes)]
