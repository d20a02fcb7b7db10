"""Port link-prediction evaluation against the JAX package on the CPU, and
the port's import and device contracts.

``LinkPredictionTrainer.evaluate`` runs the same protocol on both sides
(seeded val negatives, neg_src discarded, triple forward, per-batch
buckets) with the JAX trainer's parameters transferred into the port.

Tolerances: per-batch probabilities and losses within 1e-5 absolute (the
embeddings agree to ~1e-6, see test_torch_dygformer.py, and the head and
sigmoid do not amplify that); mean AP/AUC within 1e-5 (a score pair that
close can only swap order where the two scores are within 1e-5 already).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dyglib_tpu.models import DyGFormer as JaxDyGFormer
from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer
from dyglib_tpu.train import TrainConfig as JaxConfig
from dyglib_tpu.train.metrics import average_precision as jax_ap
from dyglib_tpu.train.metrics import roc_auc as jax_auc
from dyglib_tpu_torch.data import get_link_prediction_data
from dyglib_tpu_torch.device import resolve_device
from dyglib_tpu_torch.models import DyGFormer
from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig
from dyglib_tpu_torch.train.metrics import average_precision, roc_auc
from dyglib_tpu_torch.transfer import from_jax_params

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("maxlen,patch", [(32, 1), (32, 4)])
def test_evaluate_matches_jax(link_data, synthetic_dataset, tmp_path, maxlen, patch):
    kw = dict(max_input_sequence_length=maxlen, patch_size=patch, num_layers=2)
    jtr = JaxTrainer(
        JaxDyGFormer(**kw, use_time_kernel=False, gelu_approximate=False),
        link_data, JaxConfig(batch_size=200), str(tmp_path / "unused.pkl"),
    )
    params, _ = jtr.init_params(0)
    recorded = []  # JAX per-batch probabilities, as evaluate computes them
    batch_metrics = jtr._batch_metrics

    def record(probs, b):
        recorded.append(jtr._host_probs(probs))
        return batch_metrics(probs, b)

    jtr._batch_metrics = record
    j_losses, j_metrics, _ = jtr.evaluate(params, link_data.val, jtr.val_neg, 0, scanned=False)

    data = get_link_prediction_data("synthetic", data_root=synthetic_dataset)
    tr = LinkPredictionTrainer(DyGFormer(**kw), data, TrainConfig(batch_size=200), device="cpu")
    tr.load_params(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    losses, metrics, probs = tr.evaluate(data.val, tr.val_neg)

    assert len(probs) == len(recorded) == len(j_losses) > 1
    for (pos, neg), (jpos, jneg) in zip(probs, recorded):
        np.testing.assert_allclose(pos, jpos, atol=1e-5)
        np.testing.assert_allclose(neg, jneg, atol=1e-5)
    np.testing.assert_allclose(losses, j_losses, atol=1e-5)
    ours, ref = tr.mean_metrics(metrics), JaxTrainer.mean_metrics(j_metrics)
    assert set(ours) == set(ref) == {"average_precision", "roc_auc"}
    for k in ref:
        assert abs(ours[k] - ref[k]) <= 1e-5, (k, ours[k], ref[k])


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(5):
        labels = (rng.rand(300) < 0.5).astype(np.float64)
        scores = np.round(rng.rand(300), 2)  # many ties
        assert average_precision(labels, scores) == jax_ap(labels, scores)
        assert roc_auc(labels, scores) == pytest.approx(jax_auc(labels, scores), abs=1e-12)


def test_port_imports_no_jax_or_reference_package():
    """Importing every module of the port loads neither JAX nor dyglib_tpu
    (nor the JAX package's host dependencies)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dyglib_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "banned = {'jax', 'jaxlib', 'flax', 'optax', 'pandas', 'sklearn', 'dyglib_tpu'}\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in banned)\n"
        "print(len([n for n in sys.modules if n.startswith('dyglib_tpu_torch')]))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr + res.stdout
    assert int(res.stdout.strip().splitlines()[-1]) >= 20


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
