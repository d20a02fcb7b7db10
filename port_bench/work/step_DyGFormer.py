"""DyGFormer's products a step: the forward's and, in training, the
backward's (each weight's gradient, and each input's gradient where the
input depends on parameters: not the raw node and edge rows nor the
counts), at the published widths and the padded sequence length. Nothing
recomputed is counted."""
from port_bench import workmath

KIND = "model"
MODEL = "DyGFormer"


def flops(cfg, phase):
    m, lp, patch, rows, ced, dt, feat = workmath.dygformer({"cfg": cfg})
    pairs = 2 * (m // 3)
    fwd = bwd = 0

    def mm(n, a, c, dx=True):
        nonlocal fwd, bwd
        fwd += 2 * n * a * c
        bwd += 2 * n * a * c * (2 if dx else 1)

    mm(rows, patch * feat, ced, dx=False)  # node channel
    mm(rows, patch * feat, ced, dx=False)  # edge channel
    mm(rows, patch * dt, ced)  # time channel (Phi depends on w, b)
    entries = 2 * pairs * lp * 2  # both sides of each pair, two counts an entry
    mm(entries, 1, ced, dx=False)  # co_occurrence_fc1
    mm(entries, ced, ced)  # co_occurrence_fc2
    tokens_side = lp // patch
    mm(2 * pairs * tokens_side, patch * ced, ced)  # proj_co_occurrence
    d, t = 4 * ced, 2 * tokens_side
    for _ in range(cfg["num_layers"]):
        mm(pairs * t, d, 3 * d)  # q, k, v
        mm(pairs * cfg["num_heads"] * t, d // cfg["num_heads"], t)  # logits
        mm(pairs * cfg["num_heads"] * t, t, d // cfg["num_heads"])  # scores @ v
        mm(pairs * t, d, d)  # out_proj
        mm(pairs * t, d, 4 * d)  # ffn1
        mm(pairs * t, 4 * d, d)  # ffn2
    mm(2 * pairs, d, feat)  # output_layer
    mm(2 * (m // 3), 2 * feat, feat)  # head fc1, two pairs a row
    mm(2 * (m // 3), feat, 1)  # head fc2
    return fwd + (bwd if phase == "train" else 0)
