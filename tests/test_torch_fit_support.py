"""The rest of the port's ``fit``, on the CPU: mid-epoch resume, the
TensorBoard scalars, the profiler hook and the epoch log line, as the JAX
``fit`` has them, and the one checkpoint backend the port writes.

  * resume: a run that stops mid-epoch (after ``<save_path>.resume`` was
    written) and restarts with ``fit(resume=True)`` in a fresh trainer
    ends with the parameters, metrics and generator states of the run that
    never stopped, bitwise (TGAT under ``uniform``, dropout 0.1, seeded
    train negatives); the checkpoint holds the state dicts, the optimizer's
    state, epoch and next batch, early stopping's progress and both
    generators' states; a memory model's resume file holds its memory; the
    JAX test's round trip (``tests/test_resume.py``) logs "resuming from";
  * TensorBoard: ``crc32c`` on the known check values, the port's event
    files read back by the JAX ``read_scalar_events`` and the JAX writer's
    by the port's, a corrupted record raising, and ``fit`` writing one
    record per epoch with the JAX tags;
  * ``profile_dir``: the second epoch's ``torch.profiler`` trace lands there;
  * checkpoints are the JAX "pickle" backend's files only: ``TrainConfig``
    has no ``checkpoint_backend`` field, so asking for one (the JAX
    "orbax" directories, or "pickle") raises ``TypeError``;
  * the epoch line ends with JAX's ``(…s, ~N edges/s incl. eval)``.
"""
import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from dyglib_tpu_torch.data import get_link_prediction_data
from dyglib_tpu_torch.graph import NegativeEdgeSampler
from dyglib_tpu_torch.models import TGAT, MemoryModel, compute_src_dst_node_time_shifts
from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig, load_checkpoint
from dyglib_tpu_torch.utils import SummaryWriter, crc32c, read_scalar_events

FIT = dict(batch_size=200, learning_rate=1e-3, patience=5)
TAGS = {"train/loss", "train/average_precision", "val/average_precision", "val/roc_auc",
        "new_node_val/average_precision", "perf/epoch_seconds", "perf/edges_per_second"}


@pytest.fixture(scope="module")
def port_data(synthetic_dataset):
    return get_link_prediction_data("synthetic", data_root=synthetic_dataset)


def _trainer(d, save, backbone=None, **cfg):
    backbone = backbone or TGAT(num_neighbors=5, num_layers=1, sample_strategy="uniform")
    tr = LinkPredictionTrainer(backbone, d, TrainConfig(**{**FIT, **cfg}), save_path=save,
                               device="cpu")
    tr.train_neg = NegativeEdgeSampler(d.train.src, d.train.dst, seed=42)
    return tr


def test_resume_mid_epoch_ends_where_the_unbroken_run_ends(port_data, tmp_path):
    cfg = dict(num_epochs=2, resume_every_batches=1)
    unbroken = _trainer(port_data, str(tmp_path / "a.pkl"), **cfg)
    want = unbroken.fit(seed=0, log=lambda *a: None)

    save = str(tmp_path / "b.pkl")
    broken = _trainer(port_data, save, **cfg)
    step, calls = broken.train_step, []

    def fail_at_third_step(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt("stopped mid-epoch")
        return step(*a, **kw)

    broken.train_step = fail_at_third_step
    with pytest.raises(KeyboardInterrupt):
        broken.fit(seed=0, log=lambda *a: None)
    ck = load_checkpoint(save + ".resume")
    extra = ck["extra"]
    assert set(extra) == {"epoch", "next_batch", "opt_state", "early_best", "early_counter",
                          "generators"}
    assert (extra["epoch"], extra["next_batch"]) == (0, 2)
    assert (extra["early_best"], extra["early_counter"]) == ({}, 0)
    assert set(extra["generators"]) == {"dropout_gen", "sample_gen"}
    assert set(ck["params"]) == {"backbone", "head"} and ck["state"] is None
    opt = extra["opt_state"]["state"]
    assert opt and all(int(s["step"]) == 2 for s in opt.values())
    assert all(t.device.type == "cpu" for s in opt.values() for t in s.values())

    resumed = _trainer(port_data, save, **cfg)
    logs = []
    got = resumed.fit(seed=0, log=logs.append, resume=True)
    assert logs[1] == "resuming from epoch 1, batch 2"
    assert got["train losses"][1:] == want["train losses"][1:]
    for key in ("validate metrics", "test metrics", "new node test metrics"):
        assert got[key] == want[key], key
    for part, sd in want["params"].items():
        for k, v in sd.items():
            torch.testing.assert_close(got["params"][part][k], v, rtol=0, atol=0)
    for name in ("dropout_gen", "sample_gen"):
        assert torch.equal(getattr(resumed, name).get_state(),
                           getattr(unbroken, name).get_state())


def test_resume_round_trip_of_a_memory_model(port_data, tmp_path):
    """The JAX test's round trip (tests/test_resume.py), with TGN: the
    resume file carries the memory, and a fresh trainer completes from it."""
    shifts = compute_src_dst_node_time_shifts(port_data.train.src, port_data.train.dst,
                                              port_data.train.ts)
    tgn = lambda: MemoryModel("TGN", num_neighbors=5, time_shifts=shifts)
    save = str(tmp_path / "tgn.pkl")
    cfg = dict(num_epochs=2, resume_every_batches=2)
    first = _trainer(port_data, save, tgn(), **cfg)
    first.fit(seed=0, log=lambda *a: None)
    ck = load_checkpoint(save + ".resume")
    assert (ck["extra"]["epoch"], ck["extra"]["next_batch"]) == (1, 2)
    assert ck["state"].memory.shape == first.init_state().memory.shape
    assert np.abs(ck["state"].memory).max() > 0  # two batches committed
    logs = []
    res = _trainer(port_data, save, tgn(), **cfg).fit(seed=0, log=logs.append, resume=True)
    assert any("resuming from epoch 2, batch 2" == str(m) for m in logs)
    ap = res["test metrics"]["average_precision"]
    assert np.isfinite(ap) and 0.0 < ap <= 1.0


def test_crc32c_known_values():
    from dyglib_tpu.utils.tensorboard import crc32c as jax_crc32c

    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert crc32c(bytes(32)) == 0x8A9136AA  # RFC 3720 B.4: 32 bytes of zeros
    assert crc32c(bytes([0xFF] * 32)) == 0x62A8AB43  # and of ones
    data = np.random.RandomState(0).bytes(1000)
    assert crc32c(data) == jax_crc32c(data)


def test_event_files_read_across_packages(tmp_path):
    from dyglib_tpu.utils.tensorboard import SummaryWriter as JaxSummaryWriter
    from dyglib_tpu.utils.tensorboard import read_scalar_events as jax_read

    records = [(1, {"train/loss": 0.5, "val/roc_auc": 0.75}), (2, {"train/loss": 0.25})]
    for writer, reader, side in ((SummaryWriter, jax_read, "port"),
                                 (JaxSummaryWriter, read_scalar_events, "jax")):
        w = writer(str(tmp_path / side))
        for step, scalars in records:
            w.add_scalars(scalars, step=step)
        w.add_scalar("perf/epoch_seconds", 1.5, step=3)
        w.close()
        assert reader(w.path) == records + [(3, {"perf/epoch_seconds": 1.5})], side
    raw = bytearray(open(tmp_path / "port" / os.listdir(tmp_path / "port")[0], "rb").read())
    raw[-1] ^= 1
    bad = tmp_path / "bad.tfevents"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="payload CRC mismatch"):
        read_scalar_events(str(bad))


def test_fit_writes_tensorboard_scalars_and_a_profile(port_data, tmp_path):
    tb, prof = tmp_path / "tb", tmp_path / "prof"
    tr = _trainer(port_data, str(tmp_path / "m.pkl"), num_epochs=2,
                  tensorboard_dir=str(tb), profile_dir=str(prof))
    logs = []
    res = tr.fit(seed=0, log=logs.append)
    (events,) = os.listdir(tb)
    records = read_scalar_events(str(tb / events))
    assert [step for step, _ in records] == [1, 2]
    for (step, scalars), loss in zip(records, res["train losses"]):
        assert set(scalars) == TAGS
        assert scalars["train/loss"] == pytest.approx(loss, rel=1e-6)
        assert scalars["perf/edges_per_second"] > 0
    # the second epoch's trace (the first one is not profiled)
    (trace,) = os.listdir(prof)
    assert trace.endswith(".pt.trace.json")
    events = json.load(open(prof / trace))["traceEvents"]
    assert any(e.get("name") == "train/forward" for e in events)
    assert f"profiler trace written to {prof}" in logs
    assert logs.index(f"profiler trace written to {prof}") > 1  # after epoch 1's line


def test_epoch_line_reports_edges_per_second(port_data, tmp_path):
    logs = []
    _trainer(port_data, str(tmp_path / "m.pkl"), num_epochs=1).fit(seed=0, log=logs.append)
    line = next(m for m in logs if m.startswith("epoch 1:"))
    assert re.search(r"\(\d+\.\ds, ~\d+ edges/s incl\. eval\)$", line), line


def test_checkpoint_backend():
    assert "checkpoint_backend" not in {f.name for f in dataclasses.fields(TrainConfig)}
    for backend in ("orbax", "pickle"):
        with pytest.raises(TypeError, match="checkpoint_backend"):
            TrainConfig(checkpoint_backend=backend)
