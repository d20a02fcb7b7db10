"""The reference's link prediction: batches, loss, gradients and Adam.

A batch of B edges embeds, at the edges' times, the rows its net module's
``LAYOUT`` names, under the port's trainer's names: the triple [src ||
dst || neg_dst] ("dedup": src's rows stand for neg_src's; "triple": the
net pairs the triple itself) or the quad [src || dst || src || neg_dst]
("quad": a pair-aware net; neg_src = src in training and in
random-negative evaluation), and the dropout masks are drawn for those
rows. The loss is the mean binary cross-entropy on logits over the B
positive and B negative pairs of the real rows (padded rows weigh 0).
Training samples from the train split's history, evaluation from the
whole stream's; a random sample strategy draws its neighbours from a
``torch.Generator`` on the device, one for the train steps followed
(seeded with the run's sample seed) and one for an evaluation sweep
(seeded with the seed the port's sweep is seeded with). Adam is torch's
default (betas 0.9, 0.999, eps 1e-8, no weight decay), written out.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch
import torch.nn.functional as F

from .graph import History, time_keys
from .precision import Precision

BETAS = (0.9, 0.999)
EPS = 1e-8


def layout_of(cfg: dict) -> str:
    """The rows the reference's net for ``cfg`` embeds a batch in."""
    return importlib.import_module(f"{__package__}.{cfg['model']}").LAYOUT


class Reference:
    """The plain model of one configuration on one device."""

    def __init__(self, cfg: dict, splits, device, precision: str = "float32"):
        self.cfg = cfg
        self.net = importlib.import_module(f"{__package__}.{cfg['model']}")
        self.device = torch.device(device)
        self.prec = Precision(precision)
        n = splits.node_feats.shape[0]
        self.train_hist = History(splits.train.src, splits.train.dst, splits.train.ts,
                                  splits.train.eid, n)
        self.full_hist = History(splits.full.src, splits.full.dst, splits.full.ts,
                                 splits.full.eid, n)
        self.tables = (torch.from_numpy(splits.node_feats).to(self.device),
                       torch.from_numpy(splits.edge_feats).to(self.device))

    @property
    def layout(self) -> str:
        return self.net.LAYOUT

    def rows(self, b: int) -> int:
        """The rows a batch of ``b`` edges embeds."""
        return (4 if self.layout == "quad" else 3) * b

    def queries(self, src, dst, neg, ts) -> tuple[np.ndarray, np.ndarray]:
        """(ids, time keys) of the rows a batch embeds, in the layout."""
        parts = [src, dst, src, neg] if self.layout == "quad" else [src, dst, neg]
        return np.concatenate(parts), np.tile(time_keys(ts), len(parts))

    def inputs(self, hist: History, src, dst, neg, ts, gen=None):
        ids, t = self.queries(src, dst, neg, ts)
        return self.net.prepare(self.cfg, hist, ids, t, self.device, gen)

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the device seeded with ``seed``."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def logits(self, params, hist, batch, drops=None, gen=None):
        src, dst, neg, ts, _ = batch
        inp = self.inputs(hist, src, dst, neg, ts, gen)
        return self.net.pair_logits(params, self.cfg, self.tables, inp, self.prec, len(src),
                                    drops)

    def loss(self, params, hist, batch, drops=None, keep_rows=None, gen=None):
        """(loss, pos_logit, neg_logit); ``keep_rows`` (a fault's): count only
        these rows in the mean."""
        pos, neg = self.logits(params, hist, batch, drops, gen)
        valid = torch.from_numpy(np.asarray(batch[4], np.float32)).to(self.device)
        if keep_rows is not None:
            valid = valid * keep_rows
        bce = F.binary_cross_entropy_with_logits
        terms = (bce(pos, torch.ones_like(pos), reduction="none")
                 + bce(neg, torch.zeros_like(neg), reduction="none"))
        return (terms * valid).sum() / torch.clamp(2.0 * valid.sum(), min=1.0), pos, neg

    def draws(self, gen, rows: int):
        return self.net.dropout_draws(self.cfg, rows, gen, self.device)

    def follow(self, params0: dict, batches, dropout_seed: int, sample_seed: int, keep_after=(),
               fault=None):
        """A train step from ``params0`` on each of ``batches`` -> (each
        step's loss, the first step's gradients, {step: the parameters after
        it} for each step of ``keep_after``); the dropout masks drawn from a
        generator seeded with ``dropout_seed`` on the device, the neighbours
        from one seeded with ``sample_seed``.
        ``fault="half_batch"``: each loss is the mean over the first half of
        the rows alone."""
        params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
        gen = self.generator(dropout_seed)
        sample_gen = self.generator(sample_seed)
        losses, first, kept = [], None, {}
        for step in range(1, len(batches) + 1):
            batch = batches[step - 1]
            drops = (self.draws(gen, self.rows(len(batch[0]))) if self.cfg["dropout"] > 0
                     else None)
            keep = None
            if fault == "half_batch":
                keep = (torch.arange(len(batch[0]), device=self.device) < len(batch[0]) // 2)
                keep = keep.to(torch.float32)
            loss, _, _ = self.loss(params, self.train_hist, batch, drops, keep, sample_gen)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            losses.append(float(loss.detach()))
            with torch.no_grad():
                grads = {k: torch.zeros_like(p) if g is None else g
                         for (k, p), g in zip(params.items(), grads)}
                if first is None:
                    first = {k: g.clone() for k, g in grads.items()}
                self._adam(params, grads, m, v2, step)
                if step in keep_after:
                    kept[step] = {k: p.detach().clone() for k, p in params.items()}
        return losses, first, kept

    def _adam(self, params, grads, m, v, step: int) -> None:
        lr = self.cfg["learning_rate"]
        b1, b2 = BETAS
        for k, p in params.items():
            g = grads[k]
            m[k].mul_(b1).add_(g, alpha=1 - b1)
            v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v[k].sqrt() / (1 - b2**step) ** 0.5).add_(EPS)
            p.data.addcdiv_(m[k], denom, value=-lr / (1 - b1**step))

    @torch.no_grad()
    def evaluate(self, params: dict, batches, eval_seed: int):
        """Each batch's (loss, pos probabilities, neg probabilities), on the
        whole stream's history; the sweep's neighbours drawn from a
        generator seeded with ``eval_seed``."""
        out = []
        gen = self.generator(eval_seed)
        for batch in batches:
            loss, pos, neg = self.loss(params, self.full_hist, batch, gen=gen)
            out.append((float(loss), torch.sigmoid(pos).cpu().numpy(),
                        torch.sigmoid(neg).cpu().numpy()))
        return out
