"""DyGFormer (Yu et al., NeurIPS 2023) as DyGLib computes it, plain PyTorch.

For a pair (u, v) at time t each side's sequence is the node itself, then
its last maxlen - 1 interactions oldest first, zero padded at the end
(``graph.History.sequence``). Per entry of a side:

  * co-occurrence: its count in its own sequence and in the partner's,
    counted over the whole sequence and then zeroed at padding; each count
    c goes through fc2(relu(fc1(c))) and the two are summed;
  * node and edge features of the entry, and cos((t - t_e) w + b) zeroed
    at padding;
  * each of the four channels is cut into patches of ``patch_size``
    entries, flattened and projected to ``channel_embedding_dim``.

A side's tokens are its patches' four projections side by side (node,
edge, time, co-occurrence); the 2P tokens of [u || v] go through
``num_layers`` pre-LN blocks without a padding mask:

    x = x + drop(out_proj(attend(LN1 x)));  x = x + drop(ffn2(drop(gelu(ffn1(LN2 x)))))

with dropout on the attention scores too, exact-erf GELU, scale
1/sqrt(hd). Each side's tokens are mean-pooled and projected by
``output_layer``. The link head is fc2(relu(fc1([u || v]))). A batch
pairs (src, dst) and (src, neg_dst): the negative pair's src embedding is
its own (the joint attention sees the partner): the triple [src || dst
|| neg_dst] embedded, its pairs formed inside the net (``LAYOUT``
"triple"). Departures from DyGLib,
as in the port: integer time deltas; the co-occurrence of a padding entry
is the MLP of a zero count, as DyGLib computes it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .graph import History, occurrences

# the rows a batch embeds, under the port's trainer's name
LAYOUT = "triple"
LN_EPS = 1e-5


def seq_len(cfg: dict) -> int:
    p = cfg["patch_size"]
    return -(-cfg["max_input_sequence_length"] // p) * p


def prepare(cfg: dict, hist: History, ids: np.ndarray, t: np.ndarray, device, gen=None) -> dict:
    """Each query's sequence (ids, edge ids, times) and its time, on the
    device; ``gen`` is not drawn from (the sequence is the recent one)."""
    length = seq_len(cfg)
    sid, seid, st = hist.sequence(ids, t, min(cfg["max_input_sequence_length"], length))
    pad = length - sid.shape[1]
    if pad > 0:
        z = np.zeros((sid.shape[0], pad), np.int64)
        sid, seid, st = (np.concatenate([a, z], 1) for a in (sid, seid, st))
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)
    return dict(ids=as_t(sid), eids=as_t(seid), t=as_t(st), qt=as_t(np.asarray(t, np.int64)))


def dropout_draws(cfg: dict, rows: int, gen, device) -> list:
    """One train step's dropout masks in the order they are drawn: per
    block the scores' (2B, H, T, T), out_proj's (2B, T, d), the FFN's inner
    (2B, T, 4d) and outer (2B, T, d); ``rows`` = 3B (the triple)."""
    pairs = 2 * (rows // 3)
    tokens = 2 * seq_len(cfg) // cfg["patch_size"]
    d, heads, p = 4 * cfg["channel_embedding_dim"], cfg["num_heads"], cfg["dropout"]
    out = []
    for _ in range(cfg["num_layers"]):
        for shape in ((pairs, heads, tokens, tokens), (pairs, tokens, d), (pairs, tokens, 4 * d),
                      (pairs, tokens, d)):
            out.append(torch.rand(shape, generator=gen, device=device) < 1.0 - p)
    return out


def _patches(x: torch.Tensor, patch: int) -> torch.Tensor:
    n, length, d = x.shape
    return x.reshape(n, length // patch, patch * d)


def _side(params, cfg, tables, prec, ids, eids, st, qt, partner):
    """(n, P, 4 ced) tokens of one side of n pairs."""
    node, edge = tables
    patch = cfg["patch_size"]
    valid = ids != 0
    counts = torch.stack([occurrences(ids, ids), occurrences(ids, partner)], -1)
    counts = torch.where(valid[..., None], counts, 0.0)
    h = torch.relu(prec.linear(counts[..., None], params["co_occurrence_fc1.weight"],
                               params["co_occurrence_fc1.bias"]))
    co = prec.linear(h, params["co_occurrence_fc2.weight"], params["co_occurrence_fc2.bias"]).sum(2)
    dt = (qt[:, None] - st).to(torch.float32)
    phi = torch.cos(dt[..., None] * params["time_encoder.w"][0] + params["time_encoder.b"])
    phi = torch.where(valid[..., None], phi, 0.0)
    chans = []
    for name, x in (("proj_node", node[ids]), ("proj_edge", edge[eids]), ("proj_time", phi),
                    ("proj_co_occurrence", co)):
        chans.append(prec.linear(_patches(x, patch), params[f"{name}.weight"],
                                 params[f"{name}.bias"]))
    n, p, ced = chans[0].shape
    return torch.stack(chans, 2).reshape(n, p, 4 * ced)


def _block(params, name, cfg, prec, x, drops, p):
    n, t, d = x.shape
    heads = cfg["num_heads"]
    hd = d // heads
    ln = lambda y, k: F.layer_norm(y, (d,), params[f"{name}.{k}.weight"],
                                   params[f"{name}.{k}.bias"], LN_EPS)
    lin = lambda y, k: prec.linear(y, params[f"{name}.{k}.weight"], params[f"{name}.{k}.bias"])
    drop = (lambda y, i: y) if drops is None else (lambda y, i: y * drops[i] / (1.0 - p))
    h = ln(x, "norm1")
    q, k, v = (lin(h, f"{c}_proj").view(n, t, heads, hd) for c in "qkv")
    attn = prec.einsum("bqhd,bkhd->bhqk", q, k) / hd**0.5
    scores = drop(torch.softmax(attn, dim=-1), 0)
    hidden = prec.einsum("bhqk,bkhd->bqhd", scores, v).reshape(n, t, d)
    x = x + drop(lin(hidden, "out_proj"), 1)
    h = F.gelu(lin(ln(x, "norm2"), "ffn1"))
    return x + drop(lin(drop(h, 2), "ffn2"), 3)


def pair_logits(params, cfg, tables, inp, prec, b: int, drops=None):
    """(pos_logit, neg_logit) of the batch's B pairs; ``drops`` are the
    step's masks for all 2B joint rows."""
    i = torch.arange(b, device=inp["ids"].device)
    lrows = torch.cat([i, i])  # src of (src, dst), src of (src, neg)
    rrows = torch.cat([b + i, 2 * b + i])
    sides = []
    for own, other in ((lrows, rrows), (rrows, lrows)):
        sides.append(_side(params, cfg, tables, prec, inp["ids"][own], inp["eids"][own],
                           inp["t"][own], inp["qt"][own], inp["ids"][other]))
    x = torch.cat(sides, 1)
    for layer in range(cfg["num_layers"]):
        d = None if drops is None else drops[4 * layer : 4 * layer + 4]
        x = _block(params, f"transformer_{layer}", cfg, prec, x, d, cfg["dropout"])
    p = sides[0].shape[1]
    out = lambda y: prec.linear(y.mean(1), params["output_layer.weight"],
                                params["output_layer.bias"])
    left, right = out(x[:, :p]), out(x[:, p:])
    head = lambda a, c: prec.linear(
        torch.relu(prec.linear(torch.cat([a, c], -1), params["head.fc1.weight"],
                               params["head.fc1.bias"])),
        params["head.fc2.weight"], params["head.fc2.bias"])[:, 0]
    return head(left[:b], right[:b]), head(left[b:], right[b:])
