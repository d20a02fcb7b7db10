"""One run of one cell: set-up, the measured window, the check, the line.

  set-up   the stream and the splits from --seed, the port's trainer, the
           starting parameters, the rows a batch embeds on each side (the
           program's layout against the reference's: a run whose two
           differ is not correct), then the cell's own phase warmed: a train
           cell's first three steps (the first eager, the second captured,
           the third replayed: the steps the check follows) and one whole
           sweep; an eval cell's first sweep (eager step, capture, replays);
  window   whole sweeps until --seconds have passed (the last one ends
           past the deadline and counts), under ``torch.profiler`` with
           --trace 1;
  check    the program's state freed, the reference recomputes from the
           same inputs what the program produced, and each number compared
           is held to the cell's limit.

The result is one JSON line on standard output, the numbers compared
last on standard error.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import sys
import time

import numpy as np

from . import catalog, traffic, weights

FORBIDDEN = {"jax", "jaxlib", "flax", "dyglib_tpu"}
# the train steps a check follows: the first eager, the second captured,
# the third replayed (the set-up's sweep of the window's length after
# them is followed by calibrate.py alone: its readings swing, PERF.md §2)
FIRST_STEPS = 3


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run must not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def process_age_s() -> float | None:
    """Seconds since this process started (Linux), None where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


class Clock:
    def __init__(self):
        age = process_age_s()
        self.t0 = time.perf_counter() - (age if age is not None else 0.0)

    def since_start(self) -> float:
        return time.perf_counter() - self.t0


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------------ checks
def leaf_gaps(prog: dict, ref: dict, names) -> dict[str, float]:
    """Each leaf's |norm(prog) - norm(ref)| over the larger of the
    reference's norm of that leaf and the median leaf's norm."""
    norms = {k: float(ref[k].double().norm()) for k in names}
    median = statistics.median(norms.values())
    return {k: abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], median, 1e-30)
            for k in names}


def moving_leaves(grads_ref: dict) -> list[str]:
    """Leaves whose reference gradient is not nought to rounding: norm at
    least a thousandth of the median leaf's."""
    norms = {k: float(g.double().norm()) for k, g in grads_ref.items()}
    median = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= 1e-3 * median]


def train_gaps(prog: dict, ref: dict, p0: dict) -> dict:
    """Every reading of a train check, from each side's record (``losses``:
    each step's loss; ``g1``: the first step's gradients; ``after``: the
    parameters after the first steps and, where followed, after the
    sweep): each step's loss gap, and each leaf's gap of the first
    gradient and of the change over the first steps and over the sweep
    (the change over the moving leaves only)."""
    moving = moving_leaves(ref["g1"])
    change = lambda p: {k: p[k].double() - p0[k].double() for k in moving}
    return {"loss": [abs(a - b) / max(abs(b), 1e-30)
                     for a, b in zip(prog["losses"], ref["losses"])],
            "grad": leaf_gaps(prog["g1"], ref["g1"], list(ref["g1"])),
            **{f"change.{when}": leaf_gaps(change(prog["after"][when]),
                                           change(ref["after"][when]), moving)
               for when in ref["after"]}}


def train_numbers(gaps: dict) -> dict:
    """The numbers a train cell compares: the first step's loss, the first
    gradient by the worst leaf and by the median leaf, the change over the
    first steps by the median leaf."""
    return {"loss_gap": gaps["loss"][0], "grad_gap": max(gaps["grad"].values()),
            "grad_median_gap": statistics.median(gaps["grad"].values()),
            "change_gap": statistics.median(gaps["change.first"].values())}


def eval_numbers(prog: list, ref: list, valid: list) -> dict:
    """prog, ref: per batch (loss, pos probs, neg probs); valid: per batch
    the number of real rows."""
    prob_gap, loss_gap = 0.0, 0.0
    for (lp, pp, np_), (lr, pr, nr), n in zip(prog, ref, valid):
        prob_gap = max(prob_gap, float(np.abs(np.asarray(pp[:n], np.float64) - pr[:n]).max()),
                       float(np.abs(np.asarray(np_[:n], np.float64) - nr[:n]).max()))
        loss_gap = max(loss_gap, abs(lp - lr) / max(abs(lr), 1e-30))
    return {"prob_gap": prob_gap, "loss_gap": loss_gap}


# ------------------------------------------------------------------ the run
class Run:
    """A cell's run; ``device`` "cuda" on the card (the CPU in tests)."""

    def __init__(self, cell: dict, seed: int, seconds: float, device: str = "cuda"):
        self.cell, self.cfg = cell, cell["cfg"]
        self.seed, self.seconds, self.device = seed, seconds, device
        self.phase = cell["phase"]
        self.batch = self.cfg["batch_size"]
        self.seeds = {k: traffic.sub_seed(seed, k) for k in
                      ("init", "weights", "dropout", "negatives", "sample")}
        # the check follows the set-up's whole sweep too (calibrate.py's)
        self.follow_sweep = False

    # ---------------------------------------------------------- set-up
    def setup(self, err=sys.stderr) -> None:
        t0 = time.perf_counter()
        from . import program

        import torch

        torch.zeros(1, device=self.device)
        _sync(self.device)
        t1 = time.perf_counter()
        self.splits = traffic.make_splits(self.cfg["stream"], self.seed)
        t2 = time.perf_counter()
        self.prog = program.Program(self.cfg, self.splits, self.device)
        make = lambda shapes: weights.make(shapes, self.seeds["weights"], self.prog.device)
        self.p0 = {k: v.detach().to("cpu", copy=True) for k, v in self.prog.start(
            self.seeds["init"], make, self.seeds["dropout"], self.seeds["negatives"],
            self.seeds["sample"]).items()}
        self.eval_seed = self.prog.eval_seed
        from .reference.train import layout_of

        # (the program's, the reference's) rows of a batch of the phase
        self.layouts = (self.prog.layouts[self.phase], layout_of(self.cfg))
        t3 = time.perf_counter()
        if self.phase == "train":
            rows = lambda first, n: traffic.train_sweep_rows(len(self.splits.train), self.batch,
                                                            first, n)
            self.rows = rows
            n = self.cell["sweep_batches"]
            losses = list(self.prog.train_sweep(rows(0, 1)))
            g1 = self.prog.first_gradients()
            losses += self.prog.train_sweep(rows(1, FIRST_STEPS - 1))
            after = {"first": self.prog.parameters()}
            losses += self.prog.train_sweep(rows(FIRST_STEPS, n))
            after["sweep"] = self.prog.parameters()
            self.record = {"losses": losses, "g1": g1, "after": after}
            self.next_batch = FIRST_STEPS + n
        else:
            self.prog.eval_sweep()
        _sync(self.device)
        t4 = time.perf_counter()
        print(f"set-up: import and device context {t1 - t0:.3f} s, stream {t2 - t1:.3f} s, trainer and parameters "
              f"{t3 - t2:.3f} s, warm-up {t4 - t3:.3f} s", file=err)

    # ---------------------------------------------------------- window
    def sweep(self) -> tuple[int, int, int]:
        """One sweep -> (positive edges, steps, steps whose loss is not finite)."""
        if self.phase == "train":
            n = self.cell["sweep_batches"]
            losses = self.prog.train_sweep(self.rows(self.next_batch, n))
            self.next_batch += n
            return n * self.batch, n, sum(not math.isfinite(x) for x in losses)
        losses, probs = self.prog.eval_sweep()
        self.last_eval = [(loss, pos, neg) for loss, (pos, neg) in zip(losses, probs)]
        return len(self.splits.val), len(losses), sum(not math.isfinite(x) for x in losses)

    def window(self, record=None) -> dict:
        span = record or (lambda name: contextlib.nullcontext())
        edges = steps = failed = 0
        times = []
        _sync(self.device)
        t0 = time.perf_counter()
        with span("bench/window"):
            while True:
                ts = time.perf_counter()
                with span("bench/sweep"):
                    e, s, f = self.sweep()
                _sync(self.device)
                times.append(time.perf_counter() - ts)
                edges, steps, failed = edges + e, steps + s, failed + f
                if time.perf_counter() - t0 >= self.seconds:
                    break
        wall = time.perf_counter() - t0
        half = len(times) // 2
        return dict(edges=edges, steps=steps, failed=failed, sweeps=len(times), wall=wall,
                    sweep_s=(min(times), statistics.median(times), max(times)),
                    halves=(sum(times[:half]) / max(half, 1),
                            sum(times[half:]) / max(len(times) - half, 1)))

    # ---------------------------------------------------------- check
    def free_program(self) -> None:
        import torch

        del self.prog
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def layout_note(self) -> str | None:
        """Why the run cannot be judged where the program and the reference
        embed a batch in different rows, else None."""
        prog, ref = self.layouts
        if prog == ref:
            return None
        return (f"layout: the program embeds a {self.phase} batch as {prog!r}, the reference "
                f"as {ref!r}; the run is not correct")

    def check(self, control: str | None = None) -> dict:
        """The numbers compared (see ``gaps``)."""
        g = self.gaps(control)
        return train_numbers(g) if self.phase == "train" else g

    def gaps(self, control: str | None = None) -> dict:
        """The numbers compared: the program's record against the
        reference's; ``control`` puts the reference in the program's place,
        in TF32 (``"tf32"``) or with half of each batch left out of the
        loss's mean (``"half_batch"``), with each step of a followed sweep
        from its second on given the batch before its own
        (``"shifted_rows"``), or started from parameters one rounding away,
        each element moved by one unit in the last place (``"one_ulp"``),
        or drawing its neighbours from the seed after the program's
        (``"other_draws"``: a random sample strategy's)."""
        from .reference.precision import strict_float32
        from .reference.train import Reference

        strict_float32()
        if not hasattr(self, "_ref"):
            self._inputs = (self._train_batches() if self.phase == "train"
                            else self._eval_batches())
            self._ref = self._reference(self._reference_model())
        if control is None:
            got = self.record if self.phase == "train" else self.last_eval
        else:
            precision, fault = ("tf32", None) if control == "tf32" else ("float32", control)
            got = self._reference(Reference(self.cfg, self.splits, self.device, precision), fault)
        if self.phase == "train":
            cpu = lambda d: {k: v.detach().to("cpu") for k, v in d.items()}
            side = lambda r: {"losses": r["losses"], "g1": cpu(r["g1"]),
                              "after": {k: cpu(v) for k, v in r["after"].items()}}
            return train_gaps(side(got), side(self._ref), self.p0)
        return eval_numbers(got, self._ref, self._inputs[1])

    def _reference_model(self):
        """The float32 reference of the run's configuration, built once."""
        from .reference.train import Reference

        if not hasattr(self, "_ref_model"):
            self._ref_model = Reference(self.cfg, self.splits, self.device)
        return self._ref_model

    def pick_differences(self, other: int = 0) -> int | None:
        """Sampled entries (a hop's id, edge id, time or validity) where the
        port's sampler and the reference's differ over the queries the check
        follows, in the reference's layout, each drawing from the seed the
        check follows (calibrate.py's, while the program is alive; the
        reference from the seed ``other`` after it); None where a side's
        sample has no hop tables."""
        if self.phase == "train":
            batches, hist, seed = self._train_batches(), "train_hist", self.seeds["sample"]
        else:
            batches, hist, seed = self._eval_batches()[0], "full_hist", self.eval_seed
        ref = self._reference_model()
        queries = [ref.queries(*b[:4]) for b in batches]
        port = self.prog.neighbours(self.phase, queries, seed)
        if port is None:
            return None
        gen, diff = ref.generator(seed + other), 0
        for (ids, t), hops in zip(queries, port):
            inp = ref.net.prepare(self.cfg, getattr(ref, hist), ids, t, self.device, gen)
            if not {"ids", "eids", "t", "mask"} <= set(inp):
                return None
            for h, (nid, eid, tt, mask) in enumerate(hops):
                mine = (inp["ids"][h + 1], inp["eids"][h], inp["t"][h + 1], inp["mask"][h])
                diff += sum(int((a.cpu().numpy().reshape(-1) != b.reshape(-1)).sum())
                            for a, b in zip(mine, (nid, eid, tt, mask)))
        return diff

    def _train_batches(self) -> list:
        """The batches the set-up's steps ran, with their negatives."""
        from .reference.graph import RandomNegatives

        t = self.splits.train
        negs = RandomNegatives(t.src, t.dst, self.seeds["negatives"])
        out = []
        for i in range(FIRST_STEPS + (self.cell["sweep_batches"] if self.follow_sweep else 0)):
            r = self.rows(i, 1)
            out.append((t.src[r], t.dst[r], negs.destinations(self.batch, self.batch), t.ts[r],
                        np.ones(self.batch, np.float32)))
        return out

    def _eval_batches(self) -> tuple[list, list]:
        """(batches, real rows of each) of a sweep over the val split."""
        from .reference.graph import RandomNegatives, batch_rows

        s = self.splits
        negs = RandomNegatives(s.full.src, s.full.dst, 0)
        batches, valid = [], []
        for i in range(-(-len(s.val) // self.batch)):
            r, v = batch_rows(len(s.val), self.batch, i)
            batches.append((s.val.src[r], s.val.dst[r],
                            negs.destinations(int(v.sum()), self.batch), s.val.ts[r],
                            v.astype(np.float32)))
            valid.append(int(v.sum()))
        return batches, valid

    def _reference(self, ref, fault: str | None = None):
        """What ``ref`` gives on the run's inputs: a train cell's record
        (as ``self.record``), an eval cell's (loss, pos, neg) per batch."""
        other = int(fault == "other_draws")
        if self.phase == "eval":
            return ref.evaluate(self.p0_device(), self._inputs[0], self.eval_seed + other)
        import torch

        batches, start = self._inputs, self.p0_device()
        if fault == "shifted_rows":
            batches = batches[: FIRST_STEPS + 1] + batches[FIRST_STEPS:-1]
        if fault == "one_ulp":
            gen = torch.Generator().manual_seed(self.seeds["init"])
            start = {k: torch.nextafter(v, torch.where(
                torch.rand(v.shape, generator=gen) < 0.5, -torch.inf, torch.inf).to(v.device))
                for k, v in start.items()}
        losses, g1, after = ref.follow(start, batches, self.seeds["dropout"],
                                       self.seeds["sample"] + other, (FIRST_STEPS, len(batches)),
                                       fault if fault == "half_batch" else None)
        kept = {"first": after[FIRST_STEPS]}
        if self.follow_sweep:
            kept["sweep"] = after[len(batches)]
        return {"losses": losses, "g1": g1, "after": kept}

    def p0_device(self) -> dict:
        return {k: v.to(self.device) for k, v in self.p0.items()}


def device_info(run: Run, chips: int) -> dict:
    import torch

    if run.device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def judge(cell: dict, stats: dict, numbers: dict) -> tuple[bool, dict]:
    """(correct, each number beside its limit): every step's loss finite
    and every number within the cell's limit."""
    limits = cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return stats["failed"] == 0 and all(v["value"] <= v["limit"] for v in checks.values()), checks


def execute(cell: dict, seed: int, seconds: float, trace: bool, clock: Clock,
            device: str = "cuda", root=catalog.ROOT, out=sys.stdout, err=sys.stderr,
            control: str | None = None) -> int:
    """Set-up, window, check; prints the result line. Returns the exit code.
    ``control`` (``Run.gaps``'s) judges the reference put in the program's
    place instead of the program: the line then shows the control failing."""
    run = Run(cell, seed, seconds, device)
    run.setup()
    setup_s = clock.since_start()
    prof = None
    record = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
        record = record_function
    stats = run.window(record)
    t_stop = time.perf_counter()
    if prof is not None:
        prof.stop()
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: JAX or the JAX package", file=err)
        return 3
    dev = device_info(run, cell.get("chips", 1))
    metrics, extra = {}, {}
    if trace:
        from . import trace as tr_mod

        work = catalog.work(root)
        t_read = time.perf_counter()
        traced = tr_mod.from_profiler(prof, run.phase, cell, stats["steps"], work)
        del prof
        t_reduce = time.perf_counter()
        for name, mod in catalog.metrics(root).items():
            if getattr(mod, "PHASE", run.phase) != run.phase:
                continue
            value = mod.read(traced)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": mod.UNIT}
        tr_mod.log_notes(traced, err)
        dev["busy_s"] = traced.busy_ns() / 1e9
        dev["window_s"] = traced.window_ns / 1e9
        extra["breakdown"] = tr_mod.breakdown(traced)
        print(f"trace: {len(traced.start)} device events; profiler stop {t_read - t_stop:.1f} s, "
              f"events read {t_reduce - t_read:.1f} s, metrics "
              f"{time.perf_counter() - t_reduce:.1f} s", file=err)
    else:
        rate = stats["edges"] / stats["wall"]
        name = "train_edges_per_s" if run.phase == "train" else "eval_edges_per_s"
        metrics[name] = {"value": rate, "unit": "edges/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    run.free_program()
    correct, checks = judge(cell, stats, run.check(control))
    note = run.layout_note()
    correct = correct and note is None
    result = {"correct": correct, "attempted": stats["steps"], "failed": stats["failed"],
              "metrics": metrics, "device": dev, **extra, "checks": checks}
    lo, mid, hi = stats["sweep_s"]
    print(f"window: {stats['sweeps']} sweeps, {stats['steps']} steps, {stats['wall']:.3f} s "
          f"(a sweep {lo:.4f} / {mid:.4f} / {hi:.4f} s, least / median / most; "
          f"{stats['halves'][0]:.4f} and {stats['halves'][1]:.4f} s in the first and second "
          f"half); set-up "
          f"{setup_s:.3f} s", file=err)
    if note is not None:
        print(note, file=err)
    for k, v in checks.items():
        print(f"check {k} {v['value']:.6g} limit {v['limit']:.6g}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
