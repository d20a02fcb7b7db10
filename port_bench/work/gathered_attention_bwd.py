"""#6b gathered attention backward (``ops.gathered_attention_backward``):
TGAT's first layer at every hop, a train step."""
from port_bench import workmath

KIND = "kernel"
ANCHOR = r"attention_bwd_query_kernel<.*GatheredLoader"
LEADING = [r"head_project_kernel"]
TRAILING = [r"head_combine_kernel", r"head_weight_grad_kernel", r"strided_sum_kernel"]


def calls(cell):
    if cell["cfg"]["model"] != "TGAT" or cell["phase"] != "train":
        return []
    (feat, dt, kv, dq, heads, k), hops = workmath.tgat(cell)
    out = []
    for layer, _, m in hops:
        if layer == 1:
            ops = workmath.attention_bwd_ops(m, k, kv, dq, heads, dt, dt)
            nbytes = (workmath.attention_small_bytes(m, k, kv, dq, heads, True)
                      + 4 * (m * k * (2 * feat + 1) + 4 * dt))
            out.append((ops, nbytes))
    return out
