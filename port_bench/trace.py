"""From a ``torch.profiler`` trace of the window to per-layer numbers.

The harness wraps the window in a ``bench/window`` span and each sweep in
a ``bench/sweep`` span (``record_function``). From the profiler's events
(kineto's, read in place, not exported) it keeps:

  * the device's activity in the window: kernels, copies and fills (as
    arrays: a 20-second window holds some millions of kernels);
  * each CUDA-graph replay's envelope, from its kernels' correlation with
    the ``cudaGraphLaunch`` that started them;
  * the host's operations and spans, to say what the host was doing in
    each idle gap.

The readers in ``metrics/`` take a ``TraceRun``; the kernel functions'
work comes from ``work/`` (``kernel_shares``).
"""
from __future__ import annotations

import dataclasses
import re
import sys

import numpy as np

# the yardstick of the rooflines (NVIDIA H100 SXM, dense, at 700 W): HBM3
# bytes, and the fastest float32-accurate product (three TF32 passes at
# 495 T/s)
PEAK_BYTES = 3.35e12
PEAK_F32_ACCURATE_PRODUCTS = 495e12 / 3
GAP_LIST = 10


@dataclasses.dataclass(slots=True)
class Event:
    name: str
    start: int  # ns
    end: int  # ns


@dataclasses.dataclass
class TraceRun:
    phase: str
    cell: dict
    window: tuple[int, int]
    steps: int
    sweeps: list[Event]
    names: list[str]  # device operation names, by id
    start: np.ndarray  # device operations in the window, by start (ns)
    end: np.ndarray
    name_id: np.ndarray
    kernel: np.ndarray  # bool: a kernel (not a copy or fill)
    replays: np.ndarray  # (R, 2): each replay's first start and last end
    host: list[Event]  # host operations and spans overlapping the window
    work: dict  # {function: work module}
    notes: list[str] = dataclasses.field(default_factory=list)

    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    @property
    def kernels(self) -> int:
        return int(self.kernel.sum())

    def busy_ns(self) -> int:
        return self.window_ns - int(sum(b - a for a, b in self.idle()))

    def idle(self, extra: np.ndarray | None = None) -> list[tuple[int, int]]:
        """The window's stretches with no device operation (nor any of
        ``extra``'s (start, end) rows)."""
        start, end = self.start, self.end
        if extra is not None and len(extra):
            start = np.concatenate([start, extra[:, 0]])
            end = np.concatenate([end, extra[:, 1]])
            order = np.argsort(start, kind="stable")
            start, end = start[order], end[order]
        return _gaps(start, end, self.window)


def _gaps(start: np.ndarray, end: np.ndarray, window) -> list[tuple[int, int]]:
    """Stretches of ``window`` covered by no [start, end) (sorted by start)."""
    lo, hi = window
    keep = (end > lo) & (start < hi)
    s, e = np.clip(start[keep], lo, hi), np.clip(end[keep], lo, hi)
    if not len(s):
        return [(lo, hi)]
    reach = np.maximum.accumulate(e)
    prev = np.concatenate([[lo], reach[:-1]])
    open_ = s > prev
    out = list(zip(prev[open_].tolist(), s[open_].tolist()))
    if reach[-1] < hi:
        out.append((int(reach[-1]), hi))
    return out


def from_profiler(prof, phase: str, cell: dict, steps: int, work: dict) -> TraceRun:
    """The window of a stopped ``torch.profiler.profile``. The card-side
    shadows of host spans (``gpu_user_annotation``) are not device work."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    window, sweeps, host = None, [], []
    launches = set()
    ids: dict[str, int] = {}
    d_start, d_dur, d_name, d_corr = [], [], [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                d_start.append(ev.start_ns())
                d_dur.append(ev.duration_ns())
                d_name.append(ids.setdefault(ev.name(), len(ids)))
                d_corr.append(ev.correlation_id())
            continue
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if name == "bench/window":
            window = (start, end)
        elif name == "bench/sweep":
            sweeps.append(Event(name, start, end))
        elif "GraphLaunch" in name:
            launches.add(ev.correlation_id())
        host.append(Event(name, start, end))
    if window is None:
        raise RuntimeError("the trace has no bench/window span")
    lo, hi = window
    start = np.asarray(d_start, dtype=np.int64)
    end = start + np.asarray(d_dur, dtype=np.int64)
    name_id = np.asarray(d_name, dtype=np.int64)
    corr = np.asarray(d_corr, dtype=np.int64)
    inside = (end > lo) & (start < hi)
    order = np.argsort(start[inside], kind="stable")
    start, end = start[inside][order], end[inside][order]
    name_id, corr = name_id[inside][order], corr[inside][order]
    names = [""] * len(ids)
    for n, i in ids.items():
        names[i] = n
    is_copy = np.array([n[:6].lower() in ("memcpy", "memset") for n in names] or [False])
    replayed = np.isin(corr, np.fromiter(launches, dtype=np.int64, count=len(launches)))
    replays = np.zeros((0, 2), dtype=np.int64)
    if replayed.any():
        rc, rs, re_ = corr[replayed], start[replayed], end[replayed]
        by = np.argsort(rc, kind="stable")
        rc, rs, re_ = rc[by], rs[by], re_[by]
        first = np.flatnonzero(np.concatenate([[True], rc[1:] != rc[:-1]]))
        replays = np.stack([np.minimum.reduceat(rs, first), np.maximum.reduceat(re_, first)], 1)
        replays = replays[np.argsort(replays[:, 0])]
    host = [e for e in host if e.end > lo and e.start < hi]
    return TraceRun(phase, cell, window, steps, sorted(sweeps, key=lambda e: e.start), names,
                    start, end, name_id, ~is_copy[name_id], replays, host, work)


# ---------------------------------------------------------------- readers
def idle_share(run: TraceRun) -> float:
    return 100.0 * (1.0 - run.busy_ns() / run.window_ns)


def sweep_gap_ms(run: TraceRun) -> float | None:
    """Device-idle ms a sweep outside its replays: what the host does
    around them (staging, copies in and out, read-back, AP and AUC)."""
    if not len(run.replays) or not run.sweeps:
        return None
    return sum(b - a for a, b in run.idle(run.replays)) / len(run.sweeps) / 1e6


def kernels_per_step(run: TraceRun) -> float | None:
    return run.kernels / run.steps if run.steps else None


def _matching(run: TraceRun, patterns) -> set[int]:
    regs = [re.compile(p) for p in patterns]
    return {i for i, n in enumerate(run.names) if any(r.search(n) for r in regs)}


def _claims(run: TraceRun, fn) -> tuple[int, list[int]]:
    """(anchor kernels, indices of the kernels one kernel function
    launched): each anchor kernel, the leading kernels right before it and
    the trailing ones right after (the launches of one call are
    consecutive)."""
    kidx = np.flatnonzero(run.kernel)
    knames = run.name_id[kidx]
    anchor = _matching(run, [fn.ANCHOR])
    lead = _matching(run, getattr(fn, "LEADING", ()))
    trail = _matching(run, getattr(fn, "TRAILING", ()))
    anchors = np.flatnonzero(np.isin(knames, np.fromiter(anchor, np.int64, len(anchor))))
    out = []
    for i in anchors.tolist():
        out.append(i)
        j = i - 1
        while j >= 0 and int(knames[j]) in lead:
            out.append(j)
            j -= 1
        j = i + 1
        while j < len(knames) and int(knames[j]) in trail:
            out.append(j)
            j += 1
    return len(anchors), kidx[out].tolist()


def kernel_shares(run: TraceRun) -> dict[str, tuple[float, float]]:
    """{function: (least seconds, device seconds)} in the window, for
    each kernel function of ``work/`` that the cell runs and the trace
    shows as many times as the cell calls it. Another is named in
    ``run.notes`` and left out."""
    out, claimed = {}, set()
    for name, fn in sorted(run.work.items()):
        if getattr(fn, "KIND", "") != "kernel":
            continue
        calls = fn.calls(run.cell)
        if not calls:
            continue
        anchors, idx = _claims(run, fn)
        idx = [i for i in idx if i not in claimed]
        if anchors != run.steps * len(calls):
            run.notes.append(f"kernel function {name}: {anchors} calls in the trace where the "
                             f"cell makes {run.steps * len(calls)}; left out of kernels_roofline")
            continue
        claimed.update(idx)
        least = run.steps * sum(max(b / PEAK_BYTES, p / PEAK_F32_ACCURATE_PRODUCTS)
                                for p, b in calls)
        sel = np.asarray(idx, dtype=np.int64)
        out[name] = (least, float((run.end[sel] - run.start[sel]).sum()) / 1e9)
    return out


def kernels_roofline(run: TraceRun) -> float | None:
    shares = kernel_shares(run)
    if not shares:
        return None
    return 100.0 * sum(a for a, _ in shares.values()) / sum(b for _, b in shares.values())


def mfu(run: TraceRun) -> float | None:
    """The model's products a step, over the step's time, over the
    configuration's peak."""
    cfg = run.cell["cfg"]
    for fn in run.work.values():
        if getattr(fn, "KIND", "") == "model" and fn.MODEL == cfg["model"]:
            flops = fn.flops(cfg, run.phase)
            return 100.0 * flops * run.steps / (run.window_ns / 1e9) / cfg["peak"]["flops_per_s"]
    return None


# ---------------------------------------------------------------- breakdown
def breakdown(run: TraceRun) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing (its innermost operation or span)."""
    ops = []
    if len(run.names):
        total = np.bincount(run.name_id, weights=(run.end - run.start).astype(np.float64),
                            minlength=len(run.names))
        ops = [[_short(run.names[i]), float(total[i]) / 1e9]
               for i in np.argsort(-total)[:GAP_LIST].tolist()]
    named = []
    for a, b in sorted(run.idle(), key=lambda g: g[0] - g[1])[:GAP_LIST]:
        mid = (a + b) // 2
        inner = [e for e in run.host if e.start <= mid < e.end]
        what = min(inner, key=lambda e: e.end - e.start).name if inner else "(no host span)"
        named.append([_short(what), (b - a) / 1e9])
    return {"device_ops": ops, "idle_gaps": named}


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[: limit - 3] + "..."


def log_notes(run: TraceRun, err=sys.stderr) -> None:
    for note in run.notes:
        print(note, file=err)
