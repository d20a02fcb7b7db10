"""#6 gathered attention forward (``ops.gathered_attention``): TGAT's
first layer at every hop, its kv rows gathered raw feature rows and
Phi(dt) made inside (Phi's argument counted, its cosines not)."""
from port_bench import workmath

KIND = "kernel"
ANCHOR = r"\battention_query_kernel<.*GatheredLoader"
LEADING = [r"head_project_kernel"]
TRAILING = [r"head_combine_kernel"]


def calls(cell):
    if cell["cfg"]["model"] != "TGAT":
        return []
    (feat, dt, kv, dq, heads, k), hops = workmath.tgat(cell)
    out = []
    for layer, _, m in hops:
        if layer == 1:
            ops = workmath.attention_fwd_ops(m, k, kv, dq, heads) + 2 * m * k * dt
            nbytes = (workmath.attention_small_bytes(m, k, kv, dq, heads, False)
                      + 4 * (m * k * 2 * feat + 2 * dt))
            out.append((ops, nbytes))
    return out
