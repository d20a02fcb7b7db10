"""The program's own spans and marks in a ``TraceRun``, as per-layer numbers.

The port names two kinds of its work in a trace of the window:

  * host spans (``record_function``) around the parts of a scanned sweep,
    one of each a sweep: ``<p>/negatives``, ``<p>/staging``,
    ``<p>/replays``, ``<p>/read_back`` and ``<p>/scoring`` (``p`` the
    cell's phase);
  * mark kernels in every replayed step: ``dyglib_mark_<p>_<phase>`` at
    the start of each of the step's phases, in order, and
    ``dyglib_mark_step_end`` after its last operation. A phase's device
    time in a replay runs from its mark's start to the next mark's start.

A trace without them (a program that has none) gives None and a note in
``run.notes``, as does one whose counts are not the window's: a span not
once a sweep, more mark kernels of a phase than steps, or more than
MAX_ODD of the steps without one mark of each phase in the steps' order.
"""
from __future__ import annotations

import re

import numpy as np

from .trace import TraceRun

SWEEP_SPANS = ("negatives", "staging", "replays", "read_back", "scoring")
MARK = re.compile(r"^dyglib_mark_(\w+)$")
STEP_END = "step_end"
# the share of a window's steps that may lack one mark of each phase in order
MAX_ODD = 0.01


# ------------------------------------------------------------- host spans
def host_ms(run: TraceRun, span: str) -> float | None:
    """Host ms a sweep in the span ``<phase>/<span>``."""
    name = f"{run.phase}/{span}"
    durs = [e.end - e.start for e in run.host if e.name == name]
    if not durs or len(durs) != len(run.sweeps):
        run.notes.append(f"span {name}: {len(durs)} in the trace where the window has "
                         f"{len(run.sweeps)} sweeps; left out")
        return None
    _note_cover(run)
    return sum(durs) / len(durs) / 1e6


def _below(gaps: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The length of the sorted, disjoint (a, b) rows of ``gaps`` that lies
    before each point of ``x``."""
    a, b = gaps[:, 0], gaps[:, 1]
    cum = np.concatenate([[0], np.cumsum(b - a)])
    i = np.searchsorted(a, x, side="right") - 1
    inside = np.clip(x - a[np.maximum(i, 0)], 0, (b - a)[np.maximum(i, 0)])
    return np.where(i >= 0, cum[np.maximum(i, 0)] + inside, 0)


def cover(run: TraceRun) -> dict[str, float]:
    """{span: ns of the device-idle time outside the replays that falls in
    it}, for the sweep's spans (``sweep_gap_ms``'s time), and the whole
    under ``"idle"``."""
    gaps = np.asarray(run.idle(run.replays), dtype=np.int64).reshape(-1, 2)
    out = {"idle": float((gaps[:, 1] - gaps[:, 0]).sum())}
    for span in SWEEP_SPANS:
        ev = np.asarray([(e.start, e.end) for e in run.host if e.name == f"{run.phase}/{span}"],
                        dtype=np.int64).reshape(-1, 2)
        out[span] = float((_below(gaps, ev[:, 1]) - _below(gaps, ev[:, 0])).sum()) if len(
            gaps) else 0.0
    return out


def _note_cover(run: TraceRun) -> None:
    if getattr(run, "_cover_noted", False):
        return
    run._cover_noted = True
    c = cover(run)
    if not c["idle"]:
        return
    inside = sum(c[s] for s in SWEEP_SPANS)
    parts = ", ".join(f"{s} {100 * c[s] / c['idle']:.1f}%" for s in SWEEP_SPANS)
    run.notes.append(f"spans: {100 * inside / c['idle']:.1f}% of the device-idle time outside "
                     f"the replays ({c['idle'] / max(len(run.sweeps), 1) / 1e6:.3f} ms a sweep) "
                     f"falls in the sweep's spans ({parts})")


# ------------------------------------------------------------------ marks
def marks(run: TraceRun) -> dict[str, float] | None:
    """{phase: device ns a step} from the mark kernels (``sample``,
    ``forward``, ...), or None with a note. Read once a run."""
    if not hasattr(run, "_marks"):
        run._marks = _read_marks(run)
    return run._marks


def device_ms(run: TraceRun, *phases: str) -> float | None:
    """Device ms a replayed step in ``phases`` (summed)."""
    got = marks(run)
    if got is None:
        return None
    missing = [p for p in phases if p not in got]
    if missing:
        run.notes.append(f"marks: no {', '.join(missing)} mark in the {run.phase} steps; left out")
        return None
    return sum(got[p] for p in phases) / 1e6


def _read_marks(run: TraceRun) -> dict[str, float] | None:
    """Step k's marks are its end mark and, of each phase, the one mark
    between the previous end mark and it. A step counts where it has one of
    each, in the steps' order. The profiler's trace can lack one (the first
    of a window was seen missing) and its device clock can jump by some
    hundred us between two records, which puts a step's marks out of order
    or among its neighbour's; such steps, at most MAX_ODD of the window's,
    are left out of the means."""
    ids = {i: m.group(1) for i, n in enumerate(run.names) if (m := MARK.match(n))}
    if not ids:
        run.notes.append("marks: no mark kernel in the trace; the phase metrics are left out")
        return None
    at = {}
    for i, name in ids.items():
        at.setdefault(name, []).append(np.flatnonzero(run.name_id == i))
    at = {name: np.sort(np.concatenate(v)) for name, v in at.items()}  # by start
    counts = {name: len(v) for name, v in sorted(at.items())}
    prefix = run.phase + "_"
    if (STEP_END not in at or len(at) < 2 or max(counts.values()) > run.steps
            or any(not n.startswith(prefix) for n in at if n != STEP_END)):
        run.notes.append(f"marks: {counts} in the trace where the window has {run.steps} steps "
                         f"of {run.phase} phases; the phase metrics are left out")
        return None
    ends = run.start[at[STEP_END]]
    after = np.concatenate([[np.iinfo(np.int64).min], ends[:-1]])
    pick, good = {STEP_END: at[STEP_END]}, np.ones(len(ends), dtype=bool)
    for name, v in at.items():
        if name != STEP_END:
            t = run.start[v]
            hi, lo = np.searchsorted(t, ends), np.searchsorted(t, after, side="right")
            good &= hi - lo == 1
            pick[name] = v[np.maximum(hi - 1, 0)]
    if good.any():
        order = sorted(pick, key=lambda n: float(np.median(run.start[pick[n]][good]
                                                          - ends[good])))
        idx = np.stack([pick[n] for n in order])  # (phases + 1, steps): device operations
        good &= (np.diff(run.start[idx], axis=0) > 0).all(0)
    odd = run.steps - int(good.sum())
    if odd > MAX_ODD * run.steps:
        run.notes.append(f"marks: {counts} in the trace, {odd} of {run.steps} steps without one "
                         "of each in order; the phase metrics are left out")
        return None
    span = np.diff(run.start[idx[:, good]], axis=0).mean(1)  # each mark to the next
    out = {name[len(prefix):]: float(span[j]) for j, name in enumerate(order[:-1])}
    _note_marks(run, idx[:, good], odd, order)
    return out


def _note_marks(run: TraceRun, idx: np.ndarray, odd: int, order: list[str]) -> None:
    """What the marks found against the replays, and what they cost: their
    kernels' own time, and the time each adds to its replay. The first mark
    delays the step's first operation by (that operation's start - its
    start), the end mark ends the replay (its end - the last operation's
    end) later, a mark between two operations adds (the next one's start -
    the previous one's end) less the median gap between two other
    operations of a replay. Over the steps ``idx`` holds."""
    start, end, replays = run.start, run.end, run.replays
    steps = idx.shape[1]
    phases_ms = float((start[idx[-1]] - start[idx[0]]).mean()) / 1e6
    env_ms = float((replays[:, 1] - replays[:, 0]).mean()) / 1e6
    own_us = float((end[idx] - start[idx]).sum()) / steps / 1e3
    first, last, inner = idx[0], idx[-1], idx[1:-1].ravel()
    at = np.clip(np.searchsorted(replays[:, 0], start, side="right") - 1, 0, None)
    in_replay = (start >= replays[at, 0]) & (end <= replays[at, 1])
    is_mark = np.zeros(len(start), dtype=bool)
    is_mark[idx.ravel()] = True
    pair = in_replay[:-1] & in_replay[1:] & ~is_mark[:-1] & ~is_mark[1:] & (at[:-1] == at[1:])
    gaps = start[1:][pair] - end[:-1][pair]
    gap_us = float(np.median(gaps)) / 1e3 if len(gaps) else 0.0
    added = (float((start[first + 1] - start[first]).sum() + (end[last] - end[last - 1]).sum()
                   + (start[inner + 1] - end[inner - 1]).sum()) / 1e3
             - gap_us * len(inner)) / steps
    run.notes.append(
        f"marks: {', '.join(order)} a step; {odd} of {run.steps} steps without one of each in "
        f"order, left out; "
        f"a step's phases sum to {phases_ms:.4f} ms, its replay's envelope {env_ms:.4f} ms "
        f"({len(replays)} replays); the marks' kernels {own_us:.2f} us a step; they add "
        f"~{added:.2f} us a step ({100 * added / 1e3 / env_ms:.3f}% of the envelope; median gap "
        f"{gap_us:.3f} us)")
