"""#5b temporal attention backward (``ops.temporal_attention_backward``):
TGAT's layers above the first, a train step; dkv for every column."""
from port_bench import workmath

KIND = "kernel"
ANCHOR = r"attention_bwd_query_kernel<.*KvLoader"
LEADING = [r"head_project_kernel"]
TRAILING = [r"head_combine_kernel", r"head_weight_grad_kernel", r"strided_sum_kernel"]


def calls(cell):
    if cell["cfg"]["model"] != "TGAT" or cell["phase"] != "train":
        return []
    (feat, dt, kv, dq, heads, k), hops = workmath.tgat(cell)
    return [(workmath.attention_bwd_ops(m, k, kv, dq, heads, kv),
             workmath.attention_small_bytes(m, k, kv, dq, heads, True) + 2 * 4 * m * k * kv)
            for layer, _, m in hops if layer > 1]
