"""EdgeBank link-prediction evaluation.

Counterpart of ``dyglib_tpu/train/edgebank_eval.py``: for each test batch
the memory is rebuilt from train + val + the test edges before the batch,
on the device; negatives come from the seeded test sampler (the random
strategy keeps neg_src = src); the loss is BCE on the hard 0/1
probabilities with torch's ``BCELoss`` clamp of the log terms at -100, in
float64; AP and AUC are per batch, then averaged by the caller.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.batching import chronological_batches
from ..data.datasets import LinkPredictionData
from ..device import resolve_device
from ..graph.neg_sampler import NegativeEdgeSampler
from ..models.edgebank import edge_bank_link_prediction
from .metrics import link_prediction_metrics


def bce_clamped(probs: torch.Tensor, labels: torch.Tensor) -> float:
    """torch.nn.BCELoss's value, its log terms clamped at -100: the sum on
    the device, divided by the count on the host (a CUDA mean multiplies by
    the count's reciprocal, which can differ from numpy's mean in the last
    bit)."""
    log_p = torch.log(probs.clamp_min(0.0)).clamp_min(-100.0)
    log_1mp = torch.log((1 - probs).clamp_min(0.0)).clamp_min(-100.0)
    return float((-(labels * log_p + (1 - labels) * log_1mp)).sum()) / probs.numel()


def evaluate_edge_bank_link_prediction(
    data: LinkPredictionData,
    neg_sampler: NegativeEdgeSampler,
    batch_size: int = 200,
    edge_bank_memory_mode: str = "unlimited_memory",
    time_window_mode: str = "fixed_proportion",
    time_window_proportion: float = 0.15,
    device: str | torch.device | None = None,
) -> tuple[list[float], list[dict]]:
    """(per-batch losses, per-batch AP/AUC dicts) over the test split."""
    if neg_sampler.seed is None:
        raise ValueError("EdgeBank evaluation needs a seeded negative sampler")
    dev = resolve_device(device)
    neg_sampler.reset_random_state()
    # train, val and test in order: each batch's history is a prefix
    streams = (data.train, data.val, data.test)
    cat = lambda f: np.concatenate([getattr(s, f) for s in streams])
    h_src = torch.from_numpy(cat("src").astype(np.int64)).to(dev)
    h_dst = torch.from_numpy(cat("dst").astype(np.int64)).to(dev)
    h_ts = torch.from_numpy(cat("ts").astype(np.float64)).to(dev)
    n_before = data.train.num_interactions + data.val.num_interactions
    as_dev = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)
    losses, metrics = [], []
    for b in chronological_batches(data.test, batch_size):
        n = b.num_valid
        src, dst = b.src[:n], b.dst[:n]
        if neg_sampler.negative_sample_strategy == "random":
            _, neg_dst = neg_sampler.sample(n)
            neg_src = src
        else:
            neg_src, neg_dst = neg_sampler.sample(
                n, batch_src_node_ids=src, batch_dst_node_ids=dst,
                current_batch_start_time=b.batch_start_time,
                current_batch_end_time=b.batch_end_time)
        end = n_before + b.start
        pos_p, neg_p = edge_bank_link_prediction(
            (h_src[:end], h_dst[:end], h_ts[:end]), (as_dev(src), as_dev(dst)),
            (as_dev(neg_src), as_dev(neg_dst)),
            edge_bank_memory_mode=edge_bank_memory_mode, time_window_mode=time_window_mode,
            time_window_proportion=time_window_proportion)
        predicts = torch.cat([pos_p, neg_p])
        labels = torch.cat([torch.ones_like(pos_p), torch.zeros_like(neg_p)])
        losses.append(bce_clamped(predicts, labels))
        metrics.append(link_prediction_metrics(predicts.cpu().numpy(), labels.cpu().numpy()))
    return losses, metrics
