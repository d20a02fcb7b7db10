"""The port's configs, runners and CLI drivers against the JAX package on the CPU.

  * ``get_link_prediction_args`` / ``get_node_classification_args`` give
    the JAX namespace (apart from ``device``) for every model x dataset
    pair under ``--load_best_configs``, and for the defaults;
  * ``build_backbone`` gives each model the JAX factory's fields (the
    memory models' time shifts included); the aggregate over runs (sample
    std) and the saved results JSON equal the JAX runner's;
  * the flag whose feature the port lacks (``--fast_prng``) raises
    ``NotImplementedError`` when set, and the default ``--device cuda``
    raises without a card;
  * ``--compute_dtype bfloat16`` runs the four drivers for TGAT and
    DyGFormer on bf16 backbones, and the models that compute in f32 only
    (JODIE, DyRep, TGN, TCL, GraphMixer) ignore it, as the JAX factory does;
  * ``--show_progress`` writes each train step's loss line to stderr;
  * ``--scan_epochs`` trains one epoch through the two training drivers
    on the scanned path;
  * a CPU pipeline through the drivers (``--device cpu``): TGAT (K = 5, 1
    layer) through the four ``cli.*.main`` entry points, train ->
    evaluate (historical negatives) -> node-class train -> node-class
    evaluate, with the artifacts in DyGLib's layout and the printed
    aggregate lines; then JODIE through the runners, whose node-class
    evaluation replays train + val when the head checkpoint holds no
    memory and then gives the same test AUC (within 1e-6);
  * runner parity: one JAX ``init_params`` tree saved as a JAX checkpoint
    in one working directory and, through ``transfer.from_jax_params``, as
    the port's in another; ``run_link_prediction_evaluation`` (random
    negatives, TGAT recent) gives each aggregate within 1e-4 of JAX's;
  * ``python -m dyglib_tpu_torch.cli.train_link_prediction --help`` runs
    in a subprocess without importing JAX.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dyglib_tpu import runners as jax_runners
from dyglib_tpu.configs import build_backbone as jax_build_backbone
from dyglib_tpu.configs import get_link_prediction_args as jax_link_args
from dyglib_tpu.configs import get_node_classification_args as jax_nc_args
from dyglib_tpu.data.preprocess import DATASET_NAMES as JAX_DATASET_NAMES
from dyglib_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
from dyglib_tpu_torch import runners
from dyglib_tpu_torch.cli import (
    evaluate_link_prediction,
    evaluate_node_classification,
    train_link_prediction,
    train_node_classification,
)
from dyglib_tpu_torch.configs import (
    MODEL_NAMES,
    build_backbone,
    get_link_prediction_args,
    get_node_classification_args,
)
from dyglib_tpu_torch.data import DATASET_NAMES, get_link_prediction_data
from dyglib_tpu_torch.train import save_checkpoint
from dyglib_tpu_torch.transfer import from_jax_params

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC_MODELS = [m for m in MODEL_NAMES if m != "EdgeBank"]


def _namespace(args) -> dict:
    out = dict(vars(args))
    assert out.pop("device") == "cuda"
    return out


@pytest.mark.parametrize("dataset", DATASET_NAMES)
@pytest.mark.parametrize("model", MODEL_NAMES)
def test_link_prediction_args_match_jax(model, dataset):
    argv = ["--model_name", model, "--dataset_name", dataset, "--load_best_configs"]
    for strategy in ("random", "historical", "inductive"):
        full = argv + ["--negative_sample_strategy", strategy]
        assert _namespace(get_link_prediction_args(full, is_evaluation=True)) == vars(
            jax_link_args(full, is_evaluation=True))


@pytest.mark.parametrize("dataset", DATASET_NAMES)
@pytest.mark.parametrize("model", NC_MODELS)
def test_node_classification_args_match_jax(model, dataset):
    argv = ["--model_name", model, "--dataset_name", dataset, "--load_best_configs"]
    assert _namespace(get_node_classification_args(argv)) == vars(jax_nc_args(argv))


def test_default_args_and_names_match_jax():
    assert DATASET_NAMES == JAX_DATASET_NAMES
    assert _namespace(get_link_prediction_args([])) == vars(jax_link_args([]))
    assert _namespace(get_node_classification_args([])) == vars(jax_nc_args([]))
    assert get_link_prediction_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(AssertionError, match="EdgeBank"):
        get_link_prediction_args(["--model_name", "EdgeBank"])
    with pytest.raises(SystemExit):
        get_node_classification_args(["--model_name", "EdgeBank"])


# a field whose JAX "auto" the port stores resolved: DyGFormer's entry fetch
# ("auto" is off in the JAX package, dyglib_tpu/models/dygformer.py:546-547)
RESOLVED = {"use_entry_fetch": ("auto", False)}


@pytest.mark.parametrize("model", NC_MODELS)
def test_build_backbone_fields_match_jax(link_data, synthetic_dataset, model):
    argv = ["--model_name", model, "--dataset_name", "wikipedia", "--load_best_configs"]
    ours = build_backbone(get_link_prediction_args(argv),
                          get_link_prediction_data("synthetic", data_root=synthetic_dataset))
    ref = jax_build_backbone(jax_link_args(argv), link_data)
    assert type(ours).__name__ == type(ref).__name__
    want = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    common = [f.name for f in dataclasses.fields(ours) if f.name in want]
    assert len(common) >= 6
    for name in common:
        got = getattr(ours, name)
        if name == "time_shifts":
            assert tuple(got) == tuple(want[name])
        elif name in RESOLVED:
            assert (want[name], got) == RESOLVED[name], name
        else:
            assert got == want[name], name


def _argv(data_root, *extra):
    return ["--dataset_name", "synthetic", "--data_root", data_root, "--num_runs", "1",
            "--num_epochs", "1", "--patience", "5", "--learning_rate", "1e-3",
            *extra]


def test_aggregate_and_results_match_jax(tmp_path, monkeypatch):
    import logging

    runs = [{"average_precision": 0.61, "roc_auc": 0.7}, {"average_precision": 0.65,
            "roc_auc": 0.72}, {"average_precision": 0.6, "roc_auc": 0.69}]
    log = logging.getLogger("aggregate")
    assert runners._aggregate(log, "test", runs) == jax_runners._aggregate(log, "test", runs)
    assert runners._aggregate(log, "test", runs[:1])["roc_auc"] == (0.7, 0.0)
    args = get_link_prediction_args(["--model_name", "TGAT"])
    results = {"test metrics": runs[0], "train losses": [0.5], "params": {}}
    for side, mod in (("port", runners), ("jax", jax_runners)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        mod._save_results(args, "run", results)
    read = lambda side: (tmp_path / side / "saved_results/TGAT/wikipedia/run.json").read_text()
    assert read("port") == read("jax") and json.loads(read("port")) == {
        "test metrics": {"average_precision": "0.6100", "roc_auc": "0.7000"}}


# the parallelism flags are accepted since the port runs over rank grids
# (tests/test_torch_parallel_cli.py)
UNPORTED_FLAGS = [
    ["--fast_prng"],
]


@pytest.mark.parametrize("flag", UNPORTED_FLAGS, ids=lambda f: " ".join(f))
def test_unported_flags_raise(synthetic_dataset, tmp_path, monkeypatch, flag):
    monkeypatch.chdir(tmp_path)
    argv = _argv(synthetic_dataset, "--model_name", "TGAT", "--device", "cpu", *flag)
    for run in (runners.run_link_prediction_training, runners.run_link_prediction_evaluation):
        with pytest.raises(NotImplementedError, match="not ported|no counterpart"):
            run(get_link_prediction_args(argv, is_evaluation=True))
    for run in (runners.run_node_classification_training,
                runners.run_node_classification_evaluation):
        with pytest.raises(NotImplementedError, match="not ported|no counterpart"):
            run(get_node_classification_args(argv))
    assert not os.path.exists("saved_models")


@pytest.mark.parametrize("model,extra", [
    ("TGAT", ["--num_neighbors", "5", "--num_layers", "1"]),
    ("DyGFormer", ["--max_input_sequence_length", "16", "--patch_size", "2", "--num_layers", "1",
                   "--channel_embedding_dim", "16"]),
])
def test_compute_dtype_bfloat16_runs_the_four_drivers(synthetic_dataset, tmp_path, monkeypatch,
                                                      capsys, model, extra):
    monkeypatch.chdir(tmp_path)
    built = []

    def spy(args, data):
        built.append(build_backbone(args, data))
        return built[-1]

    monkeypatch.setattr(runners, "build_backbone", spy)
    argv = _argv(synthetic_dataset, "--model_name", model, *extra, "--device", "cpu",
                 "--compute_dtype", "bfloat16")
    train_link_prediction.main(argv)
    evaluate_link_prediction.main(argv)
    train_node_classification.main(argv)
    evaluate_node_classification.main(argv)
    assert len(built) == 4 and all(b.compute_dtype == "bfloat16" for b in built)
    lines = capsys.readouterr().out.splitlines()
    tests = [float(line.split(":")[1].split("±")[0]) for line in lines
             if line.startswith("test ")]
    assert len(tests) == 6 and all(0.0 <= v <= 1.0 for v in tests)


@pytest.mark.parametrize("model", ["JODIE", "DyRep", "TGN", "TCL", "GraphMixer"])
def test_compute_dtype_is_ignored_where_the_jax_factory_ignores_it(link_data, synthetic_dataset,
                                                                   model):
    data = get_link_prediction_data("synthetic", data_root=synthetic_dataset)
    argv = ["--model_name", model, "--dataset_name", "wikipedia", "--load_best_configs"]
    bf16 = argv + ["--compute_dtype", "bfloat16"]
    ours, plain = (build_backbone(get_link_prediction_args(a), data) for a in (bf16, argv))
    ref = jax_build_backbone(jax_link_args(bf16), link_data)
    assert not hasattr(ours, "compute_dtype") and not hasattr(ref, "compute_dtype")
    for f in dataclasses.fields(ours):
        got, want = getattr(ours, f.name), getattr(plain, f.name)
        if f.name == "time_shifts":
            assert tuple(got) == tuple(want)
        else:
            assert got == want, f.name


def test_default_device_is_cuda(synthetic_dataset, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    monkeypatch.chdir(tmp_path)
    args = get_link_prediction_args(_argv(synthetic_dataset, "--model_name", "TGAT"))
    with pytest.raises(RuntimeError, match="cuda"):
        runners.run_link_prediction_training(args)
    with pytest.raises(RuntimeError, match="cuda"):
        runners.run_link_prediction_training(args, device=None)


def test_cpu_pipeline_through_the_four_drivers(synthetic_dataset, tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.chdir(tmp_path)
    argv = _argv(synthetic_dataset, "--model_name", "TGAT", "--num_neighbors", "5",
                 "--num_layers", "1", "--device", "cpu")
    train_link_prediction.main(argv)
    evaluate_link_prediction.main(argv + ["--negative_sample_strategy", "historical"])
    train_node_classification.main(argv)
    evaluate_node_classification.main(argv)
    lines = capsys.readouterr().out.splitlines()
    printed = {line.split(":")[0]: float(line.split(":")[1].split("±")[0]) for line in lines}
    for key in ("test average_precision", "new node test roc_auc", "validate roc_auc",
                "test roc_auc"):
        assert 0.0 <= printed[key] <= 1.0, key
    # test AP and AUC from each link-prediction driver, test AUC from each node-class one
    assert sum(line.startswith("test ") for line in lines) == 6
    run = "saved_models/TGAT/synthetic/TGAT_seed0/TGAT_seed0"
    assert os.path.exists(f"{run}.pkl") and os.path.exists(f"{run}_node_classification.pkl")
    results = "saved_results/TGAT/synthetic"
    assert set(os.listdir(results)) == {
        "TGAT_seed0.json", "historical_negative_sampling_TGAT_seed0.json",
        "node_classification_TGAT_seed0.json", "evaluate_node_classification_TGAT_seed0.json"}
    saved = json.load(open(f"{results}/TGAT_seed0.json"))
    assert set(saved) == {"validate metrics", "new node validate metrics", "test metrics",
                          "new node test metrics"}
    assert set(json.load(open(f"{results}/node_classification_TGAT_seed0.json"))) == {
        "validate metrics", "test metrics"}
    assert len(os.listdir("logs/TGAT/synthetic")) == 4


def test_show_progress_prints_each_train_step(synthetic_dataset, tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.chdir(tmp_path)
    argv = _argv(synthetic_dataset, "--model_name", "TGAT", "--num_neighbors", "5",
                 "--num_layers", "1", "--device", "cpu", "--show_progress")
    runners.run_link_prediction_training(get_link_prediction_args(argv))
    err = capsys.readouterr().err
    n = -(-get_link_prediction_data("synthetic", data_root=synthetic_dataset)
          .train.num_interactions // 200)
    assert n > 1 and err.count("\rEpoch: 1, train for the ") == n
    assert f"train for the {n}-th batch, train loss: " in err and err.endswith("\n")


def test_scan_epochs_trains_one_epoch_through_the_drivers(synthetic_dataset, tmp_path,
                                                         monkeypatch, capsys):
    """``--scan_epochs`` reaches both trainers' scanned epochs and sweeps
    (on the CPU the staged loop runs uncaptured) and each driver ends with
    its aggregate."""
    from dyglib_tpu_torch.train import LinkPredictionTrainer, NodeClassificationTrainer

    calls = []
    for cls in (LinkPredictionTrainer, NodeClassificationTrainer):
        scanned = cls.train_epoch_scanned

        def spy(self, *a, _scanned=scanned, **kw):
            calls.append(type(self).__name__)
            return _scanned(self, *a, **kw)

        monkeypatch.setattr(cls, "train_epoch_scanned", spy)
    monkeypatch.chdir(tmp_path)
    argv = _argv(synthetic_dataset, "--model_name", "TGAT", "--num_neighbors", "5",
                 "--num_layers", "1", "--device", "cpu", "--scan_epochs")
    train_link_prediction.main(argv)
    train_node_classification.main(argv)
    assert calls == ["LinkPredictionTrainer", "NodeClassificationTrainer"]
    lines = capsys.readouterr().out.splitlines()
    printed = {line.split(":")[0]: float(line.split(":")[1].split("±")[0]) for line in lines}
    for key in ("test average_precision", "new node test roc_auc", "test roc_auc"):
        assert 0.0 <= printed[key] <= 1.0, key


def test_memory_model_node_class_evaluation_replays_without_state(
        synthetic_dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = _argv(synthetic_dataset, "--model_name", "JODIE", "--num_neighbors", "5",
                 "--device", "cpu")
    runners.run_link_prediction_training(get_link_prediction_args(argv))
    agg = runners.run_link_prediction_evaluation(get_link_prediction_args(
        argv + ["--negative_sample_strategy", "inductive"], is_evaluation=True))
    assert all(np.isfinite(m[0]) for split in agg.values() for m in split.values())
    nc_args = get_node_classification_args(argv)
    runners.run_node_classification_training(nc_args)
    with_state = runners.run_node_classification_evaluation(nc_args)["test"]["roc_auc"][0]
    head = "saved_models/JODIE/synthetic/JODIE_seed0/JODIE_seed0_node_classification.pkl"
    with open(head, "rb") as f:
        payload = pickle.load(f)
    assert payload["state"] is not None
    payload["state"] = None
    with open(head, "wb") as f:
        pickle.dump(payload, f)
    replayed = runners.run_node_classification_evaluation(nc_args)["test"]["roc_auc"][0]
    assert np.isfinite(replayed) and abs(replayed - with_state) <= 1e-6


def test_link_prediction_evaluation_runner_matches_jax(link_data, synthetic_dataset, tmp_path,
                                                       monkeypatch):
    from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer

    argv = _argv(synthetic_dataset, "--model_name", "TGAT", "--num_neighbors", "5",
                 "--num_layers", "1", "--dropout", "0.0")
    jax_args = jax_link_args(argv, is_evaluation=True)
    jtr = JaxTrainer(jax_build_backbone(jax_args, link_data), link_data,
                     jax_runners.train_config_from_args(jax_args), str(tmp_path / "unused.pkl"))
    params, _ = jtr.init_params(0)
    params = jax.tree_util.tree_map(np.asarray, params)
    out = {}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            jax_save_checkpoint(jax_runners.checkpoint_path(jax_args, 0), params, None)
            out[side] = jax_runners.run_link_prediction_evaluation(jax_args)
        else:
            args = get_link_prediction_args(argv + ["--device", "cpu"], is_evaluation=True)
            save_checkpoint(runners.checkpoint_path(args, 0), from_jax_params(params), None)
            out[side] = runners.run_link_prediction_evaluation(args)
    assert set(out["port"]) == set(out["jax"]) == set(runners.LINK_SPLITS)
    for split, metrics in out["jax"].items():
        assert set(out["port"][split]) == set(metrics) == {"average_precision", "roc_auc"}
        for k, (mean, std) in metrics.items():
            assert abs(out["port"][split][k][0] - mean) <= 1e-4, (split, k)
            assert out["port"][split][k][1] == std == 0.0


def test_cli_help_imports_no_jax():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['train_link_prediction', '--help']\n"
        "try:\n"
        "    runpy.run_module('dyglib_tpu_torch.cli.train_link_prediction', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in {'jax', 'dyglib_tpu'})\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr + res.stdout
    assert "--device" in res.stdout and "--load_best_configs" in res.stdout
    res = subprocess.run([sys.executable, "-m", "dyglib_tpu_torch.cli.train_link_prediction",
                          "--help"], cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "usage" in res.stdout, res.stderr
