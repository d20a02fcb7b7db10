"""#5 temporal attention forward (``ops.temporal_attention``): TGAT's
layers above the first, their kv rows [embeddings || edge || Phi(dt)]."""
from port_bench import workmath

KIND = "kernel"
ANCHOR = r"\battention_query_kernel<.*KvLoader"
LEADING = [r"head_project_kernel"]
TRAILING = [r"head_combine_kernel"]


def calls(cell):
    if cell["cfg"]["model"] != "TGAT":
        return []
    (feat, dt, kv, dq, heads, k), hops = workmath.tgat(cell)
    return [(workmath.attention_fwd_ops(m, k, kv, dq, heads),
             workmath.attention_small_bytes(m, k, kv, dq, heads, False) + 4 * m * k * kv)
            for layer, _, m in hops if layer > 1]
