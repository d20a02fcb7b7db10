"""The drivers' parallelism flags on the CPU (gloo ranks).

  * ``runners.setup_parallelism`` accepts each of the five flags that it
    refused before this slice: ``--data_parallelism`` (2 and -1),
    ``--model_parallelism``, ``--num_processes``, ``--process_id`` and
    ``--coordinator_address``, giving the (dp, mp) grid and the lead rank
    the JAX package's ``setup_parallelism`` gives (two ranks, started once;
    ``--data_parallelism 1`` alone makes a one-rank group in this
    process), and raises ``ValueError`` when dp x mp is not the process
    count or mp does not divide it;
  * ``python -m dyglib_tpu_torch.cli.train_link_prediction --num_processes 2
    --process_id i --coordinator_address 127.0.0.1:<port> --device cpu``
    in two processes, each in its own working directory, then
    ``evaluate_link_prediction`` the same way: both ranks print the same
    metrics, and only rank 0's directory gets ``saved_results``,
    ``saved_models`` and ``logs`` (``tests/test_multiprocess.py:192-196``);
    the evaluation's rank 1 gets the checkpoint from rank 0.
"""
import os
import subprocess
import sys

import pytest
import torch_dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = ["--num_processes", "2", "--process_id", "RANK", "--coordinator_address", "unused:0"]
ACCEPTED = [
    (["--data_parallelism", "2"] + WORLD, [((2, 1), True), ((2, 1), False)]),
    (["--data_parallelism", "-1"] + WORLD, [((2, 1), True), ((2, 1), False)]),
    (["--model_parallelism", "2"] + WORLD, [((1, 2), True), ((1, 2), False)]),
    (WORLD, [((2, 1), True), ((2, 1), False)]),
    (["--process_id", "RANK", "--num_processes", "1"], [(None, True), (None, True)]),
    (["--coordinator_address", "127.0.0.1:9"], [(None, True), (None, True)]),
]


@pytest.fixture(scope="module")
def accepted(synthetic_dataset):
    return torch_dist.run_ranks(torch_dist.setup_cases, 2, [f for f, _ in ACCEPTED],
                                synthetic_dataset, timeout=120)


@pytest.mark.parametrize("k", range(len(ACCEPTED)), ids=lambda k: " ".join(
    f for f in ACCEPTED[k][0] if f not in ("RANK", "unused:0")))
def test_setup_parallelism_accepts_the_flag(accepted, k):
    expected = ACCEPTED[k][1]
    assert [rank_results[k] for rank_results in accepted] == expected


def _args(synthetic_dataset, *flags):
    from dyglib_tpu_torch.configs import get_link_prediction_args

    return get_link_prediction_args(["--model_name", "TGAT", "--dataset_name", "synthetic",
                                     "--data_root", synthetic_dataset, "--device", "cpu",
                                     *flags])


def test_one_process_data_axis_makes_its_own_group(synthetic_dataset):
    from dyglib_tpu_torch.parallel import shutdown_distributed
    from dyglib_tpu_torch.runners import setup_parallelism

    try:
        mesh, lead = setup_parallelism(_args(synthetic_dataset, "--data_parallelism", "1"))
        assert mesh.shape == (1, 1) and lead and mesh.device.type == "cpu"
    finally:
        shutdown_distributed()


@pytest.mark.parametrize("flags", [
    ["--data_parallelism", "2", "--model_parallelism", "2", "--num_processes", "2"],
    ["--data_parallelism", "3", "--num_processes", "2"],
    ["--model_parallelism", "3", "--num_processes", "2"],
    ["--data_parallelism", "-2", "--num_processes", "2"],
], ids=lambda f: " ".join(f))
def test_bad_grid_raises(synthetic_dataset, flags):
    from dyglib_tpu_torch.runners import setup_parallelism

    with pytest.raises(ValueError, match="data_parallelism|model_parallelism"):
        setup_parallelism(_args(synthetic_dataset, *flags, "--coordinator_address",
                                "127.0.0.1:9"))


def _two_ranks(module, argv, cwds):
    from dyglib_tpu_torch.parallel import free_port

    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"dyglib_tpu_torch.cli.{module}", *argv, "--num_processes", "2",
         "--process_id", str(i), "--coordinator_address", f"127.0.0.1:{port}"],
        cwd=cwds[i], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [[line for line in out.splitlines() if "±" in line] for out in outs]


@pytest.fixture(scope="module")
def cli_runs(synthetic_dataset, tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_ranks")
    cwds = [root / "rank0", root / "rank1"]
    for c in cwds:
        c.mkdir()
    argv = ["--model_name", "TGAT", "--dataset_name", "synthetic", "--data_root",
            synthetic_dataset, "--num_runs", "1", "--num_epochs", "1", "--num_neighbors", "4",
            "--num_layers", "1", "--device", "cpu"]
    train = _two_ranks("train_link_prediction", argv, cwds)
    evaluate = _two_ranks("evaluate_link_prediction", argv, cwds)
    return cwds, train, evaluate


@pytest.mark.parametrize("driver", [1, 2], ids=["train", "evaluate"])
def test_cli_ranks_print_the_same_metrics(cli_runs, driver):
    lines = cli_runs[driver]
    assert lines[0] and lines[0] == lines[1]
    assert any(line.startswith("test average_precision") for line in lines[0])


@pytest.mark.parametrize("artifact", ["saved_results", "saved_models", "logs"])
def test_only_the_lead_rank_writes(cli_runs, artifact):
    cwds = cli_runs[0]
    assert os.path.isdir(cwds[0] / artifact)
    assert not os.path.exists(cwds[1] / artifact)
