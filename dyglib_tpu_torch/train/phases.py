"""The phases of a train or eval step, as profiler ranges that survive CUDA
graph capture.

``phase(name)`` opens the ``torch.profiler`` range ``name`` (``train/sample``,
``train/forward``, ...), as ``record_function`` does. A replayed step calls
no Python and so opens no range; while the current stream is capturing,
``phase`` therefore also launches the phase's mark kernel on it
(``csrc/marks.cu``: ``dyglib_mark_train_forward`` for ``train/forward``),
and ``end_step`` launches ``dyglib_mark_step_end`` after the step's last
operation. Every replay then runs the marks in the step's order: in a
profiler trace a phase's device time runs from its mark's start to the
next mark's start, and a step's phases together span its replay.

Nothing is launched outside a capture (the eager loop and the warm-up step
launch no mark) nor off ``cuda``, and the marks are not kernel-wrapper
launches: ``ops``' launch counters do not count them. A capture may not
load a library, so ``load`` runs at the warm-up step of ``StepGraphs``,
before its first capture; until then ``phase`` is ``record_function``.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

from ..ops import _build

_NAME = "marks"
# the ranges that have a mark, in the order of csrc/marks.cu kMarks; the
# last closes a step
MARKS = ("train/sample", "train/forward", "train/backward", "train/commit", "train/optimizer",
         "eval/sample", "eval/forward", "eval/head", "eval/commit", "step_end")
STEP_END = MARKS[-1]
_INDEX = {name: i for i, name in enumerate(MARKS)}

_lib = None


def kernel_name(name: str) -> str:
    """The mark kernel of range ``name`` as a profiler trace names it."""
    return "dyglib_mark_" + name.replace("/", "_")


def load() -> None:
    """Build and load the marks' library (once); from then on a capture
    launches them."""
    global _lib
    if _lib is None:
        _lib = _build.load(_NAME, "dyglib_mark", [_build.I, _build.P])


def _mark(name: str) -> None:
    if _lib is None or not torch.cuda.is_current_stream_capturing():
        return
    rc = _lib.dyglib_mark(_INDEX[name], torch.cuda.current_stream().cuda_stream)
    _build.check(_lib, rc, kernel_name(name))


@contextlib.contextmanager
def phase(name: str):
    """The profiler range ``name``; in a capture, its mark first."""
    with record_function(name):
        _mark(name)
        yield


def end_step() -> None:
    """In a capture, the mark that closes the step."""
    _mark(STEP_END)
