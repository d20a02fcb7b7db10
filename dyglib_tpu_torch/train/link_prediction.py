"""Dynamic link prediction: training and evaluation loops.

Counterpart of ``dyglib_tpu/train/link_prediction.py`` for stateless
backbones (DyGFormer, TGAT): ``TrainConfig``, ``make_optimizer``, the
train step, ``train_epoch``, ``evaluate`` and ``fit``. Not ported yet: the
memory-model paths, resume checkpoints, scan epochs, tensorboard, the
profiler hook in ``fit`` and the historical/inductive negative strategies.

Protocol (the JAX package's):
  * chronological batches, never shuffled, the last one padded and masked;
  * train negatives: only destinations are drawn (unseeded sampler),
    neg_src = src, and the backbone embeds the triple [src || dst ||
    neg_dst]: a pair-independent one (TGAT) reuses src's embeddings for
    neg_src, DyGFormer pairs the triple's rows itself (its neg_src rows'
    sequences are the src rows'); the loss is the masked mean BCE over
    positives and negatives, on logits;
  * training samples histories from train_csr, evaluation from full_csr;
  * a backbone with a stochastic sample strategy (TGAT's ``uniform``) draws
    from the trainer's ``sample_gen`` in training (seeded by
    ``init_params``) and, in each ``evaluate``, from a generator seeded
    afresh from 12345 + ``eval_key_salt`` (val / new-node val / test /
    new-node test: 0 / 1 / 2 / 3), as the JAX package seeds its key: two
    sweeps give the same probabilities. Draws differ from JAX's bits;
  * the eval samplers' seeded streams are reset before every sweep; under
    the random strategy the sampler's neg_src draw is made and discarded:
    the negative edge is (src, neg_dst), embedded as a triple too;
  * with a backbone that publishes sequence buckets (DyGFormer), each
    batch runs at the smallest bucket covering its longest strictly-before
    history; metrics are per batch, averaged over batches;
  * early stopping when no validation metric improves (ties count as
    improvement) for ``patience`` epochs, then the best checkpoint is
    reloaded for the final val / new-node val / test / new-node test sweeps.

Each train step's phases are ``torch.profiler`` ranges (``train/sample``,
``train/forward``, ``train/backward``, ``train/optimizer``) and each eval
batch's too (``eval/staging``, ``eval/sample``, ``eval/forward``,
``eval/head``, ``eval/metrics``), so a profiler trace of the real loops
breaks their time down (``scripts/profile_torch_eval.py``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..data.batching import Batch, chronological_batches
from ..data.containers import EdgeStream
from ..data.datasets import LinkPredictionData
from ..device import resolve_device
from ..graph.csr import FEAT_ENTRY_PAD, TemporalCSR, build_temporal_csr, time_keys
from ..graph.neg_sampler import NegativeEdgeSampler
from ..models.base import FeatureTables
from ..nn.modules import MergeLayer
from .early_stopping import EarlyStopping
from .metrics import link_prediction_metrics

# the JAX package's byte budget for the entry-ordered feature table
ENTRY_TABLE_BUDGET = 2_000_000_000


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 200
    num_epochs: int = 100
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    optimizer: str = "adam"
    patience: int = 20
    test_interval_epochs: int = 10
    # per-batch sequence-length bucketing for backbones that publish
    # bucket_candidates (DyGFormer)
    sequence_buckets: bool = True


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop's update rule: nu = decay * nu + (1 - decay) * g**2,
    p -= lr * g / sqrt(nu + eps), nu starting at 0.

    torch.optim.RMSprop is another rule (alpha 0.99 by default, eps outside
    the square root), so the JAX package's rmsprop is written out here.
    """

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1 - group["decay"])
                p.addcdiv_(p.grad, (nu + group["eps"]).sqrt(), value=-group["lr"])


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """Adam / SGD / RMSprop with the JAX package's update rules.

    The JAX package builds Adam's weight decay as optax's
    add_decayed_weights before scale_by_adam: the decay is added to the
    gradient, which is torch.optim.Adam's own (coupled) weight_decay.
    """
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate)
    if cfg.optimizer == "rmsprop":
        return OptaxRMSprop(params, lr=cfg.learning_rate)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


class LinkPredictionTrainer:
    """Owns the feature tables, the CSRs, the negative samplers, the
    backbone + MergeLayer head, the optimizer and the dropout and sampling
    generators for one dataset on one device."""

    def __init__(
        self,
        backbone,
        data: LinkPredictionData,
        cfg: TrainConfig,
        save_path: str | None = None,
        device: str | torch.device | None = None,
    ):
        self.backbone = backbone
        self.data = data
        self.cfg = cfg
        self.save_path = save_path
        self.device = resolve_device(device)
        dev = self.device
        self.tables = FeatureTables(
            node=torch.from_numpy(data.node_raw_features).to(dev),
            edge=torch.from_numpy(data.edge_raw_features).to(dev),
        )
        # the entry-ordered feature table, for backbones that fetch their
        # windows from it, under the JAX package's byte budget; its guard
        # pads cover the backbone's longest window
        entry = {}
        if getattr(backbone, "wants_entry_features", False) and (
            getattr(backbone, "sample_strategy", "recent") == "recent"
        ):
            width = data.node_raw_features.shape[1] + data.edge_raw_features.shape[1]
            if 2 * data.full.num_interactions * width * 4 <= ENTRY_TABLE_BUDGET:
                entry = dict(
                    feat_entry_of=(data.node_raw_features, data.edge_raw_features),
                    feat_entry_pad=max(FEAT_ENTRY_PAD, backbone.entry_window_rows),
                )
        # training samples histories from train_csr; evaluation reads full_csr
        self.train_csr = build_temporal_csr(
            data.train, num_nodes=data.num_nodes, device=dev, **entry
        )
        self.full_csr = build_temporal_csr(data.full, num_nodes=data.num_nodes, device=dev, **entry)
        # negative samplers with the reference's seeds: train unseeded,
        # val / new-node val / test / new-node test = 0 / 1 / 2 / 3
        d = data
        self.train_neg = NegativeEdgeSampler(d.train.src, d.train.dst)
        self.val_neg = NegativeEdgeSampler(d.full.src, d.full.dst, seed=0)
        self.nn_val_neg = NegativeEdgeSampler(d.new_node_val.src, d.new_node_val.dst, seed=1)
        self.test_neg = NegativeEdgeSampler(d.full.src, d.full.dst, seed=2)
        self.nn_test_neg = NegativeEdgeSampler(d.new_node_test.src, d.new_node_test.dst, seed=3)
        # sequence buckets, for backbones that publish them: smallest static
        # length covering a batch's histories
        cands = getattr(backbone, "bucket_candidates", ()) if cfg.sequence_buckets else ()
        self._buckets: tuple[int, ...] | None = tuple(cands) if len(cands) > 1 else None
        self._host_hist: dict[int, tuple[np.ndarray, np.ndarray, int]] = {}
        self.model: torch.nn.Module | None = None
        self.head: MergeLayer | None = None
        self.optimizer: torch.optim.Optimizer | None = None
        self.dropout_gen: torch.Generator | None = None
        # training's neighbor draws, for a backbone whose strategy is
        # stochastic (None otherwise: recent sampling draws nothing)
        self.sample_gen: torch.Generator | None = None
        self._stochastic = getattr(backbone, "sample_strategy", "recent") != "recent"

    # ----------------------------------------------------------- parameters
    def init_params(self, seed: int) -> None:
        """Build the backbone and head with parameters drawn from ``seed``,
        a fresh optimizer over them, and the dropout generator (and, for a
        stochastic sample strategy, the sampling generator) seeded from
        ``seed`` on the trainer's device."""
        gen = torch.Generator().manual_seed(seed)
        nd = self.tables.node_dim
        model = self.backbone.build(nd, self.tables.edge_dim, gen)
        head = MergeLayer(2 * nd, nd, 1, gen)
        self.model = model.to(self.device).eval()
        self.head = head.to(self.device).eval()
        self.optimizer = make_optimizer(
            self.cfg, list(self.model.parameters()) + list(self.head.parameters())
        )
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(seed)
        if self._stochastic:
            self.sample_gen = torch.Generator(device=self.device).manual_seed(seed)

    def load_params(self, params: dict) -> None:
        """Load ``{"backbone": state_dict, "head": state_dict}`` (see
        ``transfer.from_jax_params``; numpy arrays are accepted too)."""
        if self.model is None:
            self.init_params(0)
        as_t = lambda sd: {k: torch.as_tensor(v) for k, v in sd.items()}
        self.model.load_state_dict(as_t(params["backbone"]))
        self.head.load_state_dict(as_t(params["head"]))

    def state_dicts(self) -> dict:
        """``{"backbone": ..., "head": ...}`` state dicts of the current
        parameters (the form ``load_params`` and the checkpoints take)."""
        return {"backbone": self.model.state_dict(), "head": self.head.state_dict()}

    # -------------------------------------------------------------- forward
    def _sample(self, csr: TemporalCSR, src, dst, neg_dst, ts, bucket, gen=None):
        """The triple [src || dst || neg_dst] (neg_src = src); ``gen`` draws
        the neighbors of a stochastic sample strategy."""
        ids, tsx = torch.cat([src, dst, neg_dst]), ts.repeat(3)
        if self._stochastic:
            return self.backbone.sample(csr, ids, tsx, gen=gen)
        if bucket is None:
            return self.backbone.sample(csr, ids, tsx)
        return self.backbone.sample(csr, ids, tsx, seq_len=bucket)

    def _embed(self, inputs, dropout_gen=None) -> torch.Tensor:
        """Quad-order embeddings [src, dst, neg_src, neg_dst] of a triple's
        inputs: a pair-independent backbone embeds the triple and reuses
        src's rows for neg_src; a pair-aware one (DyGFormer) pairs the rows
        itself (``triple=True``)."""
        if getattr(self.backbone, "pair_independent", False):
            embs = self.model(self.tables, inputs, dropout_gen=dropout_gen)
            b = embs.shape[0] // 3
            return torch.cat([embs[: 2 * b], embs[:b], embs[2 * b :]])
        return self.model(self.tables, inputs, triple=True, dropout_gen=dropout_gen)

    def _head_loss(self, embs, valid):
        """Quad-order embeddings -> (masked mean BCE, (pos_logit, neg_logit))."""
        s_e, d_e, ns_e, nd_e = embs.split(valid.shape[0])
        pos_logit = self.head(s_e, d_e)[..., 0]
        neg_logit = self.head(ns_e, nd_e)[..., 0]
        bce = F.binary_cross_entropy_with_logits
        bce_pos = bce(pos_logit, torch.ones_like(pos_logit), reduction="none")
        bce_neg = bce(neg_logit, torch.zeros_like(neg_logit), reduction="none")
        loss = ((bce_pos + bce_neg) * valid).sum() / torch.clamp(2.0 * valid.sum(), min=1.0)
        return loss, (pos_logit, neg_logit)

    def train_step(self, arrays, bucket: int | None = None):
        """One optimizer step on a batch (train mode, dropout from the
        trainer's generator) -> (loss, (pos_probs, neg_probs)), detached.
        The parameters' ``.grad`` hold this step's gradients afterwards."""
        src, dst, _neg_src, neg_dst, ts, _eid, valid = arrays
        self.model.train()
        self.head.train()
        with record_function("train/sample"):
            inputs = self._sample(self.train_csr, src, dst, neg_dst, ts, bucket, self.sample_gen)
        with record_function("train/forward"):
            embs = self._embed(inputs, self.dropout_gen)
            loss, (pos_logit, neg_logit) = self._head_loss(embs, valid)
        with record_function("train/backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with record_function("train/optimizer"):
            self.optimizer.step()
        probs = (torch.sigmoid(pos_logit).detach(), torch.sigmoid(neg_logit).detach())
        return loss.detach(), probs

    @torch.inference_mode()
    def eval_step(self, csr: TemporalCSR, arrays, bucket: int | None = None, gen=None):
        """One batch under the random-negative protocol (neg_src = src) ->
        (masked mean BCE loss, (pos_probs, neg_probs)); ``gen`` draws a
        stochastic strategy's neighbors."""
        src, dst, _neg_src, neg_dst, ts, _eid, valid = arrays
        self.model.eval()
        self.head.eval()
        with record_function("eval/sample"):
            inputs = self._sample(csr, src, dst, neg_dst, ts, bucket, gen)
        with record_function("eval/forward"):
            embs = self._embed(inputs)
        with record_function("eval/head"):
            loss, (pos_logit, neg_logit) = self._head_loss(embs, valid)
            return loss, (torch.sigmoid(pos_logit), torch.sigmoid(neg_logit))

    # ---------------------------------------------------------------- loops
    def _batch_arrays(self, b: Batch, neg_src, neg_dst):
        as_dev = lambda a, dt: torch.from_numpy(np.asarray(a, dtype=dt)).to(self.device)
        i32 = np.int32
        return (
            as_dev(b.src, i32), as_dev(b.dst, i32), as_dev(neg_src, i32),
            as_dev(neg_dst, i32), as_dev(time_keys(b.ts), i32), as_dev(b.eid, i32),
            as_dev(b.valid, np.float32),
        )

    def _pad_negs(self, neg: np.ndarray, b: Batch) -> np.ndarray:
        out = np.zeros(len(b.src), dtype=np.int64)
        out[: len(neg)] = neg
        if len(neg) < len(out):
            out[len(neg):] = neg[-1] if len(neg) else 0
        return out

    def _pick_bucket(self, csr: TemporalCSR, b: Batch, neg_src, neg_dst) -> int | None:
        """Smallest static sequence bucket covering this batch's histories
        (the longest strictly-before history over all 4B query nodes, +1
        for the target), or None for the full length."""
        if not self._buckets:
            return None
        key = id(csr)
        if key not in self._host_hist:
            # composite (node, time) keys are globally sorted, so one
            # searchsorted answers all strictly-before counts at once
            offsets = csr.offsets.cpu().numpy().astype(np.int64)
            tsarr = csr.ts.cpu().numpy().astype(np.int64)
            base = int(tsarr.max()) + 2 if tsarr.size else 2
            node_of = np.repeat(np.arange(len(offsets) - 1, dtype=np.int64), np.diff(offsets))
            self._host_hist[key] = (offsets, node_of * base + tsarr, base)
        offsets, comp, base = self._host_hist[key]
        tk = time_keys(b.ts)
        ids = np.concatenate(
            [np.asarray(x, dtype=np.int64) for x in (b.src, b.dst, neg_src, neg_dst)]
        )
        qt = np.minimum(np.tile(tk, 4), base - 1)
        counts = np.searchsorted(comp, ids * base + qt, side="left") - offsets[ids]
        mx = int(counts.max()) if counts.size else 0
        if mx >= self._buckets[-1] - 1:  # counts beyond maxlen-1 are truncated
            return None
        bucket = next(c for c in self._buckets if c >= 1 + mx)
        return None if bucket == self._buckets[-1] else bucket

    def _batch_metrics(self, probs, batch: Batch) -> dict[str, float]:
        n = batch.num_valid
        pos, neg = probs[0][:n], probs[1][:n]
        predicts = np.concatenate([pos, neg])
        labels = np.concatenate([np.ones(n), np.zeros(n)])
        return link_prediction_metrics(predicts, labels)

    def train_batches(self, stream: EdgeStream | None = None):
        """(batch, arrays, bucket) for each train batch of ``stream``
        (default: the train split), drawing each batch's negatives from the
        train sampler as the batch is reached."""
        stream = self.data.train if stream is None else stream
        for b in chronological_batches(stream, self.cfg.batch_size):
            _, neg_dst = self.train_neg.sample(b.num_valid)
            neg_dst = self._pad_negs(neg_dst, b)
            bucket = self._pick_bucket(self.train_csr, b, b.src, neg_dst)
            yield b, self._batch_arrays(b, b.src, neg_dst), bucket

    def train_epoch(self, stream: EdgeStream | None = None):
        """One pass over the train split (or ``stream``) -> (per-batch
        losses, per-batch AP/AUC dicts)."""
        if self.model is None:
            raise RuntimeError("call init_params or load_params first")
        losses, metrics = [], []
        for b, arrays, bucket in self.train_batches(stream):
            loss, (pos, neg) = self.train_step(arrays, bucket)
            host = (pos.cpu().numpy(), neg.cpu().numpy())
            losses.append(float(loss))
            metrics.append(self._batch_metrics(host, b))
        return losses, metrics

    def evaluate(self, stream: EdgeStream, neg_sampler: NegativeEdgeSampler,
                 eval_key_salt: int = 0):
        """One sweep over a split; a stochastic sample strategy draws from a
        generator seeded from 12345 + ``eval_key_salt``.

        Returns (losses, metrics, probs): per batch, the loss, the AP/AUC
        dict and the host (pos_probs, neg_probs) arrays (padded rows
        included).
        """
        if self.model is None:
            raise RuntimeError("call init_params or load_params first")
        if stream.num_interactions == 0:
            return [], [], []
        neg_sampler.reset_random_state()
        gen = None
        if self._stochastic:
            gen = torch.Generator(device=self.device).manual_seed(12345 + eval_key_salt)
        losses, metrics, probs = [], [], []
        for b in chronological_batches(stream, self.cfg.batch_size):
            with record_function("eval/staging"):
                n = b.num_valid
                # the neg_src draw is made so the seeded stream stays
                # aligned, then discarded: the negative edge is (src, neg_dst)
                _, neg_dst = neg_sampler.sample(n)
                ns, nd = self._pad_negs(b.src[:n], b), self._pad_negs(neg_dst, b)
                bucket = self._pick_bucket(self.full_csr, b, ns, nd)
                arrays = self._batch_arrays(b, ns, nd)
            loss, (pos, neg) = self.eval_step(self.full_csr, arrays, bucket, gen)
            with record_function("eval/metrics"):  # the copy-back waits for the device
                host = (pos.cpu().numpy(), neg.cpu().numpy())
                losses.append(float(loss))
                metrics.append(self._batch_metrics(host, b))
                probs.append(host)
        return losses, metrics, probs

    @staticmethod
    def mean_metrics(metrics: list[dict]) -> dict[str, float]:
        if not metrics:
            return {}
        return {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}

    def fit(self, seed: int = 0, log=print) -> dict:
        """The reference's choreography for one run; returns the results
        dict with the JAX package's keys ("train losses", "validate
        metrics", "new node validate metrics", "test metrics", "new node
        test metrics", "params", "state")."""
        if self.save_path is None:
            raise ValueError("fit writes its best checkpoint to save_path; pass one")
        self.init_params(seed)
        n_params = sum(p.numel() for m in (self.model, self.head) for p in m.parameters())
        log(
            f"model name: {type(self.backbone).__name__}, "
            f"#parameters: {n_params * 4} B, {n_params * 4 / 1024:.4f} KB, "
            f"{n_params * 4 / 1024 / 1024:.4f} MB."
        )
        early = EarlyStopping(self.cfg.patience, self.save_path)
        epoch_mean_losses: list[float] = []
        d = self.data
        for epoch in range(self.cfg.num_epochs):
            t0 = time.time()
            tr_losses, tr_metrics = self.train_epoch()
            _, val_metrics, _ = self.evaluate(d.val, self.val_neg, 0)
            _, nn_val_metrics, _ = self.evaluate(d.new_node_val, self.nn_val_neg, 1)
            mv = self.mean_metrics(val_metrics)
            epoch_mean_losses.append(float(np.mean(tr_losses)))
            dt = time.time() - t0
            log(
                f"epoch {epoch + 1}: train loss {np.mean(tr_losses):.4f} "
                f"ap {self.mean_metrics(tr_metrics).get('average_precision', 0):.4f}"
                f" | val {mv} | nn-val ap "
                f"{self.mean_metrics(nn_val_metrics).get('average_precision', 0):.4f} "
                f"({dt:.1f}s)"
            )
            if (epoch + 1) % self.cfg.test_interval_epochs == 0:
                _, test_metrics, _ = self.evaluate(d.test, self.test_neg, 2)
                log(f"  test {self.mean_metrics(test_metrics)}")
            if early.step(mv, self.state_dicts()):
                log(f"early stop at epoch {epoch + 1}")
                break

        self.load_params(early.load_best()["params"])
        results: dict = {"train losses": epoch_mean_losses}
        sweeps = (
            ("validate metrics", d.val, self.val_neg),
            ("new node validate metrics", d.new_node_val, self.nn_val_neg),
            ("test metrics", d.test, self.test_neg),
            ("new node test metrics", d.new_node_test, self.nn_test_neg),
        )
        for salt, (key, stream, sampler) in enumerate(sweeps):
            results[key] = self.mean_metrics(self.evaluate(stream, sampler, salt)[1])
        results["params"] = self.state_dicts()
        results["state"] = None
        return results

