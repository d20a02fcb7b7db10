"""The run with its timed path broken underneath comes out not correct:
a step that leaves its state unchanged, half of the batch left out of the
loss's mean, an answer altered where it is produced. (One card: no
exchange between chips to leave out.)"""
import io
import json

import pytest
import torch

from dyglib_tpu_torch.train.link_prediction import LinkPredictionTrainer
from port_bench import catalog, harness

from . import _tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("tiny"))


def correct(root, name) -> bool:
    out = io.StringIO()
    rc = harness.execute(catalog.cell(name, root), 3, 0.1, False, harness.Clock(), device="cpu",
                         root=root, out=out, err=io.StringIO())
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])["correct"]


def half_batch(monkeypatch):
    real = LinkPredictionTrainer._head_loss

    def head_loss(self, embs, valid, denom=None):
        keep = (torch.arange(valid.shape[0], device=valid.device) < valid.shape[0] // 2)
        return real(self, embs, valid * keep, denom)

    monkeypatch.setattr(LinkPredictionTrainer, "_head_loss", head_loss)


def frozen_state(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def altered_answer(monkeypatch):
    for entry in ("train_step", "eval_step"):
        real = getattr(LinkPredictionTrainer, entry)

        def step(self, *a, _real=real, **kw):
            loss, (pos, neg), *rest = _real(self, *a, **kw)
            pos = pos.clone()
            pos[0] = 1.0 - pos[0]
            return (loss * 1.01, (pos, neg), *rest)

        monkeypatch.setattr(LinkPredictionTrainer, entry, step)


FAULTS = [("train", frozen_state), ("train", half_batch), ("train", altered_answer),
          ("eval", half_batch), ("eval", altered_answer)]


@pytest.mark.parametrize("model", sorted(_tiny.CONFIGS))
@pytest.mark.parametrize("phase,fault", FAULTS, ids=[f"{p}-{f.__name__}" for p, f in FAULTS])
def test_fault_is_caught(root, monkeypatch, model, phase, fault):
    fault(monkeypatch)
    assert correct(root, f"{model}.{phase}") is False


@pytest.mark.parametrize("model", sorted(_tiny.CONFIGS))
def test_unbroken_run_is_correct(root, model):
    assert correct(root, f"{model}.train") is True
