"""TGAT (Xu et al., ICLR 2020) as DyGLib computes it, plain PyTorch.

For queries (node, t) the L-hop neighbourhood is sampled once, by the
configuration's ``sample_neighbor_strategy`` (``graph.History``; hop h:
K**h entries a query), and the layers run bottom-up:

    h^0(x)   = node_features[x]
    h^l(x,t) = Merge_l(MHA_l(q = [h^{l-1}(x) || Phi(0)],
                             kv = [h^{l-1}(nbr) || edge_features[e] || Phi(t - t_e)]),
                       node_features[x])

MHA: q = Wq q_in (no bias), key = Wk kv, val = Wv kv (no bias), per head
softmax((q . key) / sqrt(hd)) with -1e10 at padded neighbours, dropout
on the scores, the weighted sum of val, then residual_fc, dropout and
LayerNorm(out + q_in). Merge: fc2(relu(fc1([a || b]))). Phi(d) =
cos(d w + b). Layer l's parameters serve every hop. Departures from
DyGLib, as in the port: time deltas are exact integer differences of
time keys, and the scores' dropout masks are drawn before residual_fc's.
The link head is Merge(2D -> D -> 1) on [src || dst] embeddings.

A batch embeds the triple [src || dst || neg_dst] (the embeddings
depend only on (node, time), so neg_src = src reuses src's rows):
``LAYOUT`` "dedup".
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .graph import TIA_ALPHA, History

# the rows a batch embeds, under the port's trainer's name
LAYOUT = "dedup"
LN_EPS = 1e-5
NEG = -1e10


def prepare(cfg: dict, hist: History, ids: np.ndarray, t: np.ndarray, device, gen=None) -> dict:
    """The sampled neighbourhood of queries (ids, t) as device tensors; the
    configuration's random strategy draws from ``gen``, hop after hop, in
    the hop's query shape (B,) then (B, K**h)."""
    k, layers = cfg["num_neighbors"], cfg["num_layers"]
    strategy = cfg["sample_neighbor_strategy"]
    alpha = cfg.get("time_scaling_factor", TIA_ALPHA)
    q_ids, q_t = [np.asarray(ids, np.int64)], [np.asarray(t, np.int64)]
    eids, masks = [], []
    b = len(q_ids[0])
    for h in range(layers):
        shape = (b,) if h == 0 else (b, k**h)
        nid, eid, tt, mask = hist.sample(strategy, q_ids[-1].reshape(-1), q_t[-1].reshape(-1), k,
                                         gen, shape, alpha)
        q_ids.append(nid.reshape(-1))
        q_t.append(tt.reshape(-1))
        eids.append(eid.reshape(-1))
        masks.append(mask.reshape(-1))
    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)
    return dict(ids=[as_t(a, torch.int64) for a in q_ids], t=[as_t(a, torch.int64) for a in q_t],
                eids=[as_t(a, torch.int64) for a in eids],
                mask=[as_t(a, torch.bool) for a in masks])


def dropout_draws(cfg: dict, rows: int, gen, device) -> list:
    """The dropout masks of one train step, in the order they are drawn:
    per attention call (layer 1 hops 0..L-1, ..., layer L hop 0) the
    scores' (M, H, K) then residual_fc's (M, Dq)."""
    p, k, heads = cfg["dropout"], cfg["num_neighbors"], cfg["num_heads"]
    dq = cfg["node_dim"] + cfg["time_feat_dim"]
    out = []
    for layer in range(1, cfg["num_layers"] + 1):
        for h in range(cfg["num_layers"] - layer + 1):
            m = rows * k**h
            for shape in ((m, heads, k), (m, dq)):
                keep = torch.rand(shape, generator=gen, device=device) < 1.0 - p
                out.append(keep)
    return out


def _phi(params, d: torch.Tensor) -> torch.Tensor:
    return torch.cos(d[..., None] * params["time_encoder.w"][0] + params["time_encoder.b"])


def _merge(params, name, prec, a, b):
    h = prec.linear(torch.cat([a, b], -1), params[f"{name}.fc1.weight"], params[f"{name}.fc1.bias"])
    return prec.linear(torch.relu(h), params[f"{name}.fc2.weight"], params[f"{name}.fc2.bias"])


def _attention(params, name, cfg, prec, q_in, kv, mask, drops, p):
    m, k, _ = kv.shape
    heads = cfg["num_heads"]
    dq = q_in.shape[-1]
    hd = dq // heads
    q = prec.linear(q_in, params[f"{name}.query_projection.weight"]).view(m, heads, hd)
    key = prec.linear(kv, params[f"{name}.key_projection.weight"]).view(m, k, heads, hd)
    val = prec.linear(kv, params[f"{name}.value_projection.weight"]).view(m, k, heads, hd)
    logits = prec.einsum("mhd,mkhd->mhk", q, key) * hd**-0.5
    logits = torch.where(mask[:, None, :], logits, NEG)
    scores = torch.softmax(logits, dim=-1)
    if drops is not None:
        scores = scores * (drops[0].to(torch.float32) / (1.0 - p))
    out = prec.einsum("mhk,mkhd->mhd", scores, val).reshape(m, dq)
    out = prec.linear(out, params[f"{name}.residual_fc.weight"], params[f"{name}.residual_fc.bias"])
    if drops is not None:
        out = out * drops[1] / (1.0 - p)
    return F.layer_norm(out + q_in, (dq,), params[f"{name}.layer_norm.weight"],
                        params[f"{name}.layer_norm.bias"], LN_EPS)


def embed(params: dict, cfg: dict, tables, inp: dict, prec, drops=None) -> torch.Tensor:
    """(Q, D) embeddings of the prepared queries; ``drops``: the step's
    dropout masks (``dropout_draws``), None in evaluation."""
    node, edge = tables
    k, layers = cfg["num_neighbors"], cfg["num_layers"]
    feats = [node[ids] for ids in inp["ids"]]
    base = list(feats)
    d_idx = 0
    for layer in range(1, layers + 1):
        new = []
        for h in range(layers - layer + 1):
            m = inp["ids"][h].shape[0]
            dt = (inp["t"][h][:, None] - inp["t"][h + 1].view(m, k)).to(torch.float32)
            phi0 = _phi(params, torch.zeros(m, device=dt.device))
            kv = torch.cat([feats[h + 1].view(m, k, -1), edge[inp["eids"][h]].view(m, k, -1),
                            _phi(params, dt)], -1)
            d = None if drops is None else drops[d_idx : d_idx + 2]
            d_idx += 2
            out = _attention(params, f"temporal_conv_{layer - 1}", cfg, prec,
                             torch.cat([feats[h], phi0], -1), kv, inp["mask"][h].view(m, k), d,
                             cfg["dropout"])
            new.append(_merge(params, f"merge_{layer - 1}", prec, out, base[h]))
        feats = new
    return feats[0]


def pair_logits(params, cfg, tables, inp, prec, b: int, drops=None):
    """(pos_logit, neg_logit), each (B,), for the triple's B pairs."""
    e = embed(params, cfg, tables, inp, prec, drops)
    src, dst, neg = e[:b], e[b : 2 * b], e[2 * b :]
    return (_merge(params, "head", prec, src, dst)[:, 0],
            _merge(params, "head", prec, src, neg)[:, 0])
