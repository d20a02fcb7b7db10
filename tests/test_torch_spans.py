"""The profiler's names for a scanned sweep's parts and a captured step's
phases (``train/link_prediction.py``, ``train/phases.py``).

On the CPU, on a small synthetic stream (TGAT, K = 5, 1 layer, dropout
0.1): a scanned train sweep and a scanned eval sweep each open
``<p>/negatives``, ``<p>/staging``, ``<p>/replays``, ``<p>/read_back`` and
``<p>/scoring`` once, in that order, around the whole sweep; the step's own
ranges keep their names, once a batch, inside ``<p>/replays``, and the
per-batch loop's are those it had; the phase helper launches no mark
outside a capture, and in one the marks of ``csrc/marks.cu`` in the step's
order (a stand-in library records them).

The ``cuda`` test (skipped without a card; ``python -m pytest --noconftest
-m cuda tests/test_torch_spans.py`` on the card): on a captured TGAT train
sweep and eval sweep, every replay runs one mark of each phase, in order,
and the step-end mark, the eager loop none; losses and probabilities equal
the eager loop's within 1e-5 and ``StepGraphs.launches()`` counts what the
loop launches, no mark among them.
"""
import contextlib
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dyglib_tpu_torch import ops
from dyglib_tpu_torch.data import synthetic_link_prediction_data
from dyglib_tpu_torch.graph import NegativeEdgeSampler
from dyglib_tpu_torch.models import TGAT
from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig, phases

B = 200
SWEEP_SPANS = ("negatives", "staging", "replays", "read_back", "scoring")
STEP_RANGES = {"train": ("train/sample", "train/forward", "train/backward", "train/optimizer"),
               "eval": ("eval/sample", "eval/forward", "eval/head")}
MARKS_CU = Path(phases.__file__).resolve().parent.parent / "csrc" / "marks.cu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU steps in a worker among others: one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    return synthetic_link_prediction_data(num_src=120, num_dst=60, num_edges=2000,
                                          node_feat_scale=1.0, seed=7)


@pytest.fixture(scope="module")
def scanned(data):
    """{phase: the ranges a scanned sweep of it opens}, traced once."""
    return {phase: _ranges(lambda: _sweep(_trainer(data), data, phase))
            for phase in ("train", "eval")}


def _trainer(d, device="cpu", **cfg):
    tr = LinkPredictionTrainer(TGAT(num_neighbors=5, num_layers=1, dropout=0.1), d,
                               TrainConfig(batch_size=B, learning_rate=1e-3,
                                           sequence_buckets=False, **cfg), device=device)
    tr.init_params(0)
    tr.train_neg = NegativeEdgeSampler(d.train.src, d.train.dst, seed=42)
    return tr


def _sweep(tr, d, phase, scanned=True):
    if phase == "train":
        return (tr.train_epoch_scanned if scanned else tr.train_epoch)()
    return tr.evaluate(d.val, tr.val_neg, scanned=scanned)


def _ranges(fn):
    """(name, start, end) of the ``train/*`` and ``eval/*`` ranges that
    ``fn()`` opens, by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(("train/", "eval/"))]
    return sorted(out, key=lambda r: r[1])


def _batches(d, phase):
    n = (d.train if phase == "train" else d.val).num_interactions
    return -(-n // B)


@pytest.mark.parametrize("phase", ["train", "eval"])
def test_a_scanned_sweep_opens_its_five_spans_in_order(scanned, phase):
    ranges = scanned[phase]
    spans = [r for r in ranges if r[0].split("/")[1] in SWEEP_SPANS]
    assert [r[0] for r in spans] == [f"{phase}/{s}" for s in SWEEP_SPANS]
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))
    # everything else the sweep opens lies inside them
    rest = [r for r in ranges if r not in spans]
    assert rest and all(any(s[1] <= r[1] and r[2] <= s[2] for s in spans) for r in rest)


@pytest.mark.parametrize("phase", ["train", "eval"])
def test_the_step_ranges_keep_their_names(data, scanned, phase):
    """Scanned: each step range once a batch, inside ``<p>/replays``; the
    per-batch loop: the ranges it opened before, and no sweep span but its
    own ``eval/staging``."""
    n = _batches(data, phase)
    ranges = scanned[phase]
    replays = next(r for r in ranges if r[0] == f"{phase}/replays")
    for name in STEP_RANGES[phase]:
        got = [r for r in ranges if r[0] == name]
        assert len(got) == n, name
        assert all(replays[1] <= r[1] and r[2] <= replays[2] for r in got), name
    loop = {r[0] for r in _ranges(lambda: _sweep(_trainer(data), data, phase, scanned=False))}
    own = {"train": set(), "eval": {"eval/staging", "eval/metrics"}}[phase]
    assert loop == set(STEP_RANGES[phase]) | own


class _FakeMarks:
    """A stand-in for the marks' library: records the marks launched."""

    def __init__(self):
        self.launched = []

    def dyglib_mark(self, which, stream):
        self.launched.append(phases.MARKS[which])
        return 0


def test_the_phase_helper_launches_nothing_off_cuda(data, monkeypatch):
    """A CPU sweep leaves the library unloaded and marks nothing; with a
    library loaded, nothing outside a capture either; in one, the step's
    marks in order."""
    tr = _trainer(data)
    _sweep(tr, data, "train")
    assert phases._lib is None
    fake = _FakeMarks()
    capturing = [False]
    monkeypatch.setattr(phases, "_lib", fake)
    monkeypatch.setattr(phases, "torch", types.SimpleNamespace(cuda=types.SimpleNamespace(
        is_current_stream_capturing=lambda: capturing[0],
        current_stream=lambda: types.SimpleNamespace(cuda_stream=0))))
    arrays = tr._stack([(b, b.src, neg) for b, neg in tr._train_negatives()][:1])
    step = tuple(x[0] for x in arrays)
    tr.train_step(step)
    tr.eval_step(tr.full_csr, step)
    phases.end_step()
    assert fake.launched == []
    capturing[0] = True
    tr.train_step(step)
    phases.end_step()
    tr.eval_step(tr.full_csr, step)
    phases.end_step()
    assert fake.launched == [*STEP_RANGES["train"], "step_end", *STEP_RANGES["eval"],
                             "step_end"]


def test_the_marks_are_the_library_s_in_its_order():
    src = MARKS_CU.read_text()
    table = re.search(r"kMarks\[\] = \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"dyglib_mark_\w+", table) == [phases.kernel_name(m) for m in phases.MARKS]
    for m in phases.MARKS:
        assert f"DYGLIB_MARK({phases.kernel_name(m)[len('dyglib_mark_'):]})" in src
    assert "marks" in ops._build.KERNEL_SOURCES


# ---------------------------------------------------------------- the card
def _marks_in(prof) -> list[str]:
    kern = [(e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and e.name().startswith("dyglib_mark_")]
    return [n for _, n in sorted(kern)]


def _snapshot(tr):
    """Parameters, optimizer state and generators, copied (``_restore`` puts
    them back in place, so that a captured graph stays valid)."""
    params = [p.detach().clone() for m in (tr.model, tr.head) for p in m.parameters()]
    opt = [{k: v.clone() for k, v in s.items()} for s in tr.optimizer.state.values()]
    gens = [g.get_state() for g in (tr.dropout_gen, tr.sample_gen) if g is not None]
    return params, opt, gens


def _restore(tr, snap):
    params, opt, gens = snap
    with torch.no_grad():
        for p, v in zip((p for m in (tr.model, tr.head) for p in m.parameters()), params):
            p.copy_(v)
        for s, v in zip(tr.optimizer.state.values(), opt):
            for k in s:
                s[k].copy_(v[k])
    for g, st in zip((g for g in (tr.dropout_gen, tr.sample_gen) if g is not None), gens):
        g.set_state(st)
    tr.train_neg.reset_random_state()


@pytest.mark.cuda
def test_replays_run_one_mark_of_each_phase_in_order(data):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = _trainer(data, torch.device("cuda"), scan_epochs=True)
    tr.train_epoch()  # the optimizer's state exists before the snapshot
    snap = _snapshot(tr)

    def run(scanned, traced=True):
        _restore(tr, snap)
        ops.reset_launch_counts()
        tr.graphs.reset_counts()
        trace = profile(activities=[ProfilerActivity.CUDA]) if traced else contextlib.nullcontext()
        with trace as prof:
            runs = [_sweep(tr, data, phase, scanned) for phase in ("train", "eval")]
            torch.cuda.synchronize()
        launches = {k: v + tr.graphs.launches().get(k, 0)
                    for k, v in ops.launch_counts().items()}
        return runs, (_marks_in(prof) if traced else None), launches, tr.graphs.replays

    run(True, traced=False)  # each sweep's warm-up step and capture; the marks loaded
    r0, m0, n0, _ = run(False)
    r1, m1, n1, replays = run(True)
    assert phases._lib is not None and m0 == []  # the eager loop marks nothing
    nt, ne = _batches(data, "train"), _batches(data, "eval")
    assert replays == nt + ne
    step = lambda p: [phases.kernel_name(r) for r in STEP_RANGES[p]] + ["dyglib_mark_step_end"]
    assert m1 == step("train") * nt + step("eval") * ne
    (t0, e0), (t1, e1) = r0, r1
    np.testing.assert_allclose(t0[0], t1[0], atol=1e-5)
    np.testing.assert_allclose(e0[0], e1[0], atol=1e-5)
    for (a, b), (c, e) in zip(e0[2], e1[2]):
        np.testing.assert_allclose(a, c, atol=1e-5, rtol=0)
        np.testing.assert_allclose(b, e, atol=1e-5, rtol=0)
    assert n0 == n1 and any(n0.values())
