"""EdgeBank in the port (torch, on the device) against the JAX package's
(numpy and pandas) on the CPU, exactly.

For each memory mode (unlimited, time window by fixed proportion, time
window by repeat interval, repeat threshold) and each negative strategy
(random, historical, inductive; the evaluation CLI's test sampler): the
per-batch losses and AP/AUC of ``evaluate_edge_bank_link_prediction`` equal
the JAX package's, and so do the memory and the 0/1 probabilities of one
history (train + val + the first half of test) for every mode, and the
time windows' memories key for key. The repeat interval's window is a
float64 mean on both sides (pandas' groupby there, a segment mean over the
stable-sorted keys here).
"""
import types

import numpy as np
import pytest
import torch

from dyglib_tpu.models.edgebank import edge_bank_link_prediction as jax_link_prediction
from dyglib_tpu.models.edgebank import edge_bank_time_window_memory as jax_time_window
from dyglib_tpu.runners import _build_eval_neg_samplers as jax_eval_samplers
from dyglib_tpu.train.edgebank_eval import evaluate_edge_bank_link_prediction as jax_evaluate
from dyglib_tpu_torch.data import get_link_prediction_data
from dyglib_tpu_torch.data.containers import EdgeStream
from dyglib_tpu_torch.graph import build_eval_neg_samplers
from dyglib_tpu_torch.models import edge_bank_link_prediction, edge_bank_memory
from dyglib_tpu_torch.train import evaluate_edge_bank_link_prediction

MODES = [
    ("unlimited_memory", "fixed_proportion"),
    ("time_window_memory", "fixed_proportion"),
    ("time_window_memory", "repeat_interval"),
    ("repeat_threshold_memory", "fixed_proportion"),
]


@pytest.fixture(scope="module")
def port_data(synthetic_dataset):
    return get_link_prediction_data("synthetic", data_root=synthetic_dataset)


@pytest.mark.parametrize("strategy", ["random", "historical", "inductive"])
@pytest.mark.parametrize("mode,window", MODES)
def test_evaluation_equals_jax(link_data, port_data, strategy, mode, window):
    args = types.SimpleNamespace(negative_sample_strategy=strategy)
    ref = jax_eval_samplers(args, link_data)[2]
    ours = build_eval_neg_samplers(port_data, strategy)[2]
    kw = dict(edge_bank_memory_mode=mode, time_window_mode=window)
    jlosses, jmetrics = jax_evaluate(link_data, ref, **kw)
    losses, metrics = evaluate_edge_bank_link_prediction(port_data, ours, **kw, device="cpu")
    assert len(losses) == len(jlosses) > 1
    assert losses == jlosses
    assert metrics == jmetrics


def _history(d):
    half = d.test.num_interactions // 2
    cat = lambda f: np.concatenate([getattr(d.train, f), getattr(d.val, f),
                                    getattr(d.test, f)[:half]])
    return cat("src"), cat("dst"), cat("ts"), half


@pytest.mark.parametrize("mode,window", MODES)
def test_memory_and_probabilities_equal_jax(link_data, port_data, mode, window):
    src, dst, ts, half = _history(port_data)
    d = port_data.test
    pos = (d.src[half:], d.dst[half:])
    rng = np.random.RandomState(0)
    neg = (rng.choice(np.unique(src), d.num_interactions - half), d.dst[half:])
    kw = dict(edge_bank_memory_mode=mode, time_window_mode=window)
    history = EdgeStream(src=src, dst=dst, ts=ts, eid=np.zeros_like(src),
                         label=np.zeros(len(src)))
    jpos, jneg = jax_link_prediction(history, pos, neg, **kw)
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = edge_bank_link_prediction((t(src), t(dst), t(ts)), (t(pos[0]), t(pos[1])),
                                    (t(neg[0]), t(neg[1])), **kw)
    np.testing.assert_array_equal(got[0].numpy(), jpos)
    np.testing.assert_array_equal(got[1].numpy(), jneg)
    assert 0 < jpos.sum() < len(jpos)
    if mode == "time_window_memory":  # the window's members, key for key
        want = np.asarray(jax_time_window(src, dst, ts, window, 0.15))
        mem = edge_bank_memory(t(src), t(dst), t(ts), mode, window, 0.15).numpy()
        np.testing.assert_array_equal(mem, want)
        keys = (src.astype(np.int64) << 32) | dst.astype(np.int64)
        assert len(mem) < len(np.unique(keys))


def test_unknown_mode_raises():
    z = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="edge_bank_memory_mode"):
        edge_bank_memory(z, z, z.double(), "no_memory")
    with pytest.raises(ValueError, match="time_window_mode"):
        edge_bank_memory(z, z, z.double(), "time_window_memory", "no_window")
