"""Evaluation metrics: Average Precision and ROC-AUC in numpy.

Counterpart of ``dyglib_tpu/train/metrics.py`` (same semantics as
sklearn's ``average_precision_score`` / ``roc_auc_score``). Link-prediction
metrics are computed per batch and then averaged across batches.
"""
from __future__ import annotations

import numpy as np


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AP = sum_n (R_n - R_{n-1}) * P_n over descending distinct scores."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    if y_true.shape != y_score.shape:
        raise ValueError("labels and scores differ in shape")
    n_pos = y_true.sum()
    if n_pos == 0:
        return 0.0
    order = np.argsort(-y_score, kind="mergesort")
    y = y_true[order]
    s = y_score[order]
    tps = np.cumsum(y)
    fps = np.cumsum(1.0 - y)
    # threshold boundaries: last index of each distinct-score run
    idxs = np.concatenate([np.nonzero(np.diff(s))[0], [len(y) - 1]])
    tp, fp = tps[idxs], fps[idxs]
    precision = tp / (tp + fp)
    recall = tp / n_pos
    return float(np.sum(np.diff(np.concatenate([[0.0], recall])) * precision))


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Tie-aware ROC-AUC via the Mann-Whitney U statistic."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    if y_true.shape != y_score.shape:
        raise ValueError("labels and scores differ in shape")
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    s = y_score[order]
    # average 1-based ranks over runs of tied scores
    starts = np.concatenate([[0], np.nonzero(np.diff(s))[0] + 1])
    ends = np.concatenate([starts[1:], [len(s)]])
    run_rank = (starts + ends + 1) / 2.0
    ranks = np.repeat(run_rank, ends - starts)
    u = ranks[y_true[order] == 1].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def link_prediction_metrics(predicts: np.ndarray, labels: np.ndarray) -> dict[str, float]:
    """AP + ROC-AUC for one batch."""
    return {
        "average_precision": average_precision(labels, predicts),
        "roc_auc": roc_auc(labels, predicts),
    }
