"""Dynamic link prediction: the evaluation half of the trainer.

Counterpart of ``dyglib_tpu/train/link_prediction.py`` (``__init__``, the
eval forward, ``_pad_negs``, ``_pick_bucket``, ``_batch_metrics``, the
per-batch ``evaluate`` and ``mean_metrics``). Training, the optimizer and
the memory-model paths come with later slices.

Evaluation protocol (the JAX package's):
  * chronological batches, the last one padded and masked;
  * the sampler's seeded stream is reset before every sweep;
  * under the random strategy the sampler's neg_src draw is made and then
    discarded: the negative edge is (src, neg_dst);
  * since neg_src = src and 'recent' sampling is deterministic, DyGFormer
    embeds the triple [src || dst || neg_dst] (its src rows' sequences are
    the neg_src rows') and returns quad-order embeddings;
  * each batch runs at the smallest sequence bucket covering its longest
    strictly-before history; metrics are per batch, averaged over batches.

Each batch's phases are ``torch.profiler`` ranges (``eval/staging``,
``eval/sample``, ``eval/forward``, ``eval/head``, ``eval/metrics``), so a
profiler trace of ``evaluate`` breaks its time down
(``scripts/profile_torch_eval.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..data.batching import Batch, chronological_batches
from ..data.containers import EdgeStream
from ..data.datasets import LinkPredictionData
from ..device import resolve_device
from ..graph.csr import TemporalCSR, build_temporal_csr, time_keys
from ..graph.neg_sampler import NegativeEdgeSampler
from ..models.base import FeatureTables
from ..nn.modules import MergeLayer
from .metrics import link_prediction_metrics


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 200


class LinkPredictionTrainer:
    """Owns the feature tables, the CSRs, the seeded eval samplers and the
    backbone + MergeLayer head for one dataset on one device."""

    def __init__(
        self,
        backbone,
        data: LinkPredictionData,
        cfg: TrainConfig,
        device: str | torch.device | None = None,
    ):
        self.backbone = backbone
        self.data = data
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        self.tables = FeatureTables(
            node=torch.from_numpy(data.node_raw_features).to(dev),
            edge=torch.from_numpy(data.edge_raw_features).to(dev),
        )
        # training samples histories from train_csr; evaluation reads full_csr
        self.train_csr = build_temporal_csr(data.train, num_nodes=data.num_nodes, device=dev)
        self.full_csr = build_temporal_csr(data.full, num_nodes=data.num_nodes, device=dev)
        # eval negative samplers with the reference's seeds
        # (val / new-node val / test / new-node test = 0 / 1 / 2 / 3)
        d = data
        self.val_neg = NegativeEdgeSampler(d.full.src, d.full.dst, seed=0)
        self.nn_val_neg = NegativeEdgeSampler(d.new_node_val.src, d.new_node_val.dst, seed=1)
        self.test_neg = NegativeEdgeSampler(d.full.src, d.full.dst, seed=2)
        self.nn_test_neg = NegativeEdgeSampler(d.new_node_test.src, d.new_node_test.dst, seed=3)
        # sequence buckets: smallest static length covering a batch's histories
        cands = backbone.bucket_candidates
        self._buckets: tuple[int, ...] | None = tuple(cands) if len(cands) > 1 else None
        self._host_hist: dict[int, tuple[np.ndarray, np.ndarray, int]] = {}
        self.model: torch.nn.Module | None = None
        self.head: MergeLayer | None = None

    # ----------------------------------------------------------- parameters
    def init_params(self, seed: int) -> None:
        """Build the backbone and head with parameters drawn from ``seed``."""
        gen = torch.Generator().manual_seed(seed)
        nd = self.tables.node_dim
        model = self.backbone.build(nd, self.tables.edge_dim, gen)
        head = MergeLayer(2 * nd, nd, 1, gen)
        self.model = model.to(self.device).eval()
        self.head = head.to(self.device).eval()

    def load_params(self, params: dict) -> None:
        """Load ``{"backbone": state_dict, "head": state_dict}`` (see
        ``transfer.from_jax_params``)."""
        if self.model is None:
            self.init_params(0)
        self.model.load_state_dict(params["backbone"])
        self.head.load_state_dict(params["head"])

    # -------------------------------------------------------------- forward
    @torch.inference_mode()
    def eval_step(self, csr: TemporalCSR, arrays, bucket: int | None = None):
        """One batch under the random-negative protocol (neg_src = src) ->
        (masked mean BCE loss, (pos_probs, neg_probs))."""
        src, dst, _neg_src, neg_dst, ts, _eid, valid = arrays
        b = src.shape[0]
        with record_function("eval/sample"):
            ids, tsx = torch.cat([src, dst, neg_dst]), ts.repeat(3)
            inputs = self.backbone.sample(csr, ids, tsx, seq_len=bucket)
        with record_function("eval/forward"):
            embs = self.model(self.tables, inputs, triple=True)  # quad order
        with record_function("eval/head"):
            s_e, d_e, ns_e, nd_e = embs.split(b)
            pos_logit = self.head(s_e, d_e)[..., 0]
            neg_logit = self.head(ns_e, nd_e)[..., 0]
            bce = F.binary_cross_entropy_with_logits
            bce_pos = bce(pos_logit, torch.ones_like(pos_logit), reduction="none")
            bce_neg = bce(neg_logit, torch.zeros_like(neg_logit), reduction="none")
            loss = ((bce_pos + bce_neg) * valid).sum() / torch.clamp(2.0 * valid.sum(), min=1.0)
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

    def evaluate(self, stream: EdgeStream, neg_sampler: NegativeEdgeSampler):
        """One sweep over a split.

        Returns (losses, metrics, probs): per batch, the loss, the AP/AUC
        dict and the host (pos_probs, neg_probs) arrays (padded rows
        included).
        """
        if self.model is None:
            raise RuntimeError("call init_params or load_params first")
        if stream.num_interactions == 0:
            return [], [], []
        neg_sampler.reset_random_state()
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
            loss, (pos, neg) = self.eval_step(self.full_csr, arrays, bucket)
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
