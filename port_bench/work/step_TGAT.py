"""TGAT's products a step: the forward's and, in training, the backward's
(each weight's gradient and each input's that needs one), at the
published widths. The attention is counted as its least form, the one
the kernels compute: the query folded into Wk (qk = Wk_h q_h) and the
weighted kv rows into Wv (out_h = (sum_j w_j kv_j) Wv_h), never a key or
value row. Nothing recomputed is counted."""
from port_bench import workmath

KIND = "model"
MODEL = "TGAT"


def flops(cfg, phase):
    (feat, dt, kv, dq, heads, k), hops = workmath.tgat({"cfg": cfg})
    fwd = bwd = 0
    for _, _, m in hops:
        lin = 2 * m * dq * dq * 2  # query_projection, residual_fc
        attn = 4 * m * dq * kv + 4 * m * heads * k * kv  # qk, out, logits, Av
        merge = 2 * m * (dq + feat) * feat + 2 * m * feat * feat
        fwd += lin + attn + merge
        bwd += 2 * (lin + attn + merge)
    b = cfg["batch_size"]
    head = 2 * (2 * b * 2 * feat * feat + 2 * b * feat)  # two pairs a row
    fwd += head
    bwd += 2 * head
    return fwd + (bwd if phase == "train" else 0)
