"""Work arithmetic shared by the files of ``work/``, copied from
``chip_smoke.py`` (``attention_fwd_ops``, ``attention_bwd_ops``,
``attention_small_bytes`` and the counts in ``check_kernels`` and
``check_training_kernels``). Operations are counted from the cell's
shapes, each input byte read once and each output byte written once.
"""
from __future__ import annotations


def attention_fwd_ops(m, k, kv_dim, dq, heads) -> int:
    """A temporal attention forward as the kernels compute it (no kv row
    projected): qk = Wk_h q3_h and out_h = Av_h Wv_h (2 dq kv_dim each a
    query), the logits and Av (2 kv_dim each per (query, head,
    neighbour)), ~6 for the mask, softmax and keep."""
    return 4 * m * dq * kv_dim + 4 * m * heads * k * kv_dim + 6 * m * heads * k


def attention_bwd_ops(m, k, kv_dim, dq, heads, kv_cols, phi_cols=0) -> int:
    """qk, gv, dq3, dWk, dWv (10 dq kv_dim a query); logits, ds_d, Ak, Av
    (8 kv_dim per (query, head, neighbour)); dkv's needed columns (4 each);
    ~12 for the softmax's backward; Phi's argument (2) and -sin dPhi, dtb,
    dtw (5) per kv row and Phi column where dtw and dtb are returned."""
    return (10 * m * dq * kv_dim + 8 * m * heads * k * kv_dim + 4 * m * heads * k * kv_cols
            + 12 * m * heads * k + 7 * m * k * phi_cols)


def attention_small_bytes(m, k, kv_dim, dq, heads, backward: bool) -> int:
    """An attention kernel's operands but its kv rows: q3, mask, keep, the
    weights, the output (backward: dout, dq3 and the weights' gradients)."""
    if backward:
        return 4 * (3 * m * dq + 2 * m * k + m * heads * k + 4 * kv_dim * dq)
    return 4 * (2 * m * dq + 2 * m * k + m * heads * k + 2 * kv_dim * dq)


def tgat(cell: dict):
    """TGAT's attention shapes: (feat, dt, kv_dim, dq, heads, k) and per
    attention call (layer, hop, queries M) of one step; a batch embeds
    3B rows (the triple)."""
    c = cell["cfg"]
    feat, dt, k = c["node_dim"], c["time_feat_dim"], c["num_neighbors"]
    rows = 3 * c["batch_size"]
    calls = [(layer, h, rows * k**h) for layer in range(1, c["num_layers"] + 1)
             for h in range(c["num_layers"] - layer + 1)]
    return (feat, dt, 2 * feat + dt, feat + dt, c["num_heads"], k), calls


def dygformer(cell: dict):
    """DyGFormer's shapes: (M rows = 3B, Lp, patch, rows of patches, ced,
    Dt, feature width)."""
    c = cell["cfg"]
    patch = c["patch_size"]
    lp = -(-c["max_input_sequence_length"] // patch) * patch
    m = 3 * c["batch_size"]
    return m, lp, patch, m * (lp // patch), c["channel_embedding_dim"], c["time_feat_dim"], \
        c["node_dim"]
