"""The program's spans and marks read from a hand-made timeline: host ms a
sweep in each span, device ms a step in each phase, the idle time the
spans cover, and None with a note where a span or a mark is missing."""
import types

from port_bench import spans, trace

from .test_port_bench_trace import Ev

# a replay's device operations from its start: (name, offset, duration);
# the marks open the phases, the last closes the step
REPLAY = [("dyglib_mark_train_sample", 0, 2), ("k_sample", 10, 100),
          ("dyglib_mark_train_forward", 120, 2), ("k_forward", 130, 200),
          ("dyglib_mark_train_backward", 340, 2), ("k_backward", 350, 400),
          ("dyglib_mark_train_optimizer", 760, 2), ("k_adam", 770, 30),
          ("dyglib_mark_step_end", 810, 2)]
# a sweep's spans from its start: (span, offset, duration)
SPANS = [("negatives", 0, 500), ("staging", 500, 500), ("replays", 1000, 1500),
         ("read_back", 2500, 200), ("scoring", 2700, 800)]


def timeline(drop=None, spans_too=True):
    """Window [0, 10000); two sweeps at 0 and 5000, each one replay that
    starts 1100 into it. ``drop``: a device operation's name left out of
    the second replay."""
    ev = [Ev("bench/window", 0, 10000), Ev("bench/sweep", 0, 4000), Ev("bench/sweep", 5000, 4000)]
    for s, corr in ((0, 1), (5000, 2)):
        ev.append(Ev("cudaGraphLaunch", s + 1050, 5, corr=corr))
        if spans_too:
            ev += [Ev(f"train/{name}", s + at, dur) for name, at, dur in SPANS]
        ev += [Ev(name, s + 1100 + at, dur, True, corr) for name, at, dur in REPLAY
               if not (corr == 2 and name == drop)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: ev)))
    return trace.from_profiler(prof, "train", {"cfg": {}}, 2, {})


def test_host_ms_a_sweep():
    run = timeline()
    for name, _, dur in SPANS:
        assert abs(spans.host_ms(run, name) - dur / 1e6) < 1e-18
    assert any(n.startswith("spans: ") for n in run.notes)


def test_device_ms_a_step_from_mark_to_mark():
    run = timeline()
    assert abs(spans.device_ms(run, "sample") - 120 / 1e6) < 1e-18
    assert abs(spans.device_ms(run, "forward") - 220 / 1e6) < 1e-18
    assert abs(spans.device_ms(run, "backward") - 420 / 1e6) < 1e-18
    assert abs(spans.device_ms(run, "optimizer") - 50 / 1e6) < 1e-18
    assert abs(spans.device_ms(run, "forward", "backward") - 640 / 1e6) < 1e-18
    # the phases sum to the replay's envelope less the end mark's 2 ns
    assert sum(spans.marks(run).values()) == 810
    assert run.replays.tolist() == [[1100, 1912], [6100, 6912]]
    assert sum("a step's phases sum to 0.0008 ms" in n for n in run.notes) == 1
    assert spans.device_ms(run, "head") is None
    assert any("no head mark" in n for n in run.notes)


def test_the_spans_cover_the_idle_time_outside_the_replays():
    c = spans.cover(timeline())
    assert c["idle"] == 10000 - 2 * 812
    assert [c[s] for s, _, _ in SPANS] == [1000, 1000, 2 * (1500 - 812), 400, 1600]


def test_a_missing_mark_leaves_the_phases_out():
    run = timeline(drop="dyglib_mark_train_forward")
    assert spans.device_ms(run, "sample") is None
    assert spans.device_ms(run, "backward") is None
    assert sum(n.startswith("marks: ") for n in run.notes) == 1  # read once


def replays_with_a_clock_jump(steps, jump_at, jump=-400, lost=()):
    """One sweep of ``steps`` replays 1000 ns apart, each as REPLAY; every
    device record from replay ``jump_at`` on is stamped ``jump`` ns off, as
    a profiler's device clock can jump: that replay starts inside the one
    before it. ``lost``: (replay, name) records the trace lacks."""
    ev = [Ev("bench/window", 0, 10 + 1000 * steps), Ev("bench/sweep", 0, 10 + 1000 * steps)]
    for k in range(steps):
        base = 10 + 1000 * k + (jump if k >= jump_at else 0)
        ev.append(Ev("cudaGraphLaunch", 5, 1, corr=k + 1))
        ev += [Ev(name, base + at, dur, True, k + 1) for name, at, dur in REPLAY
               if (k, name) not in lost]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: ev)))
    return trace.from_profiler(prof, "train", {"cfg": {}}, steps, {})


def test_a_clock_jump_leaves_its_steps_out():
    run = replays_with_a_clock_jump(200, 120)
    assert spans.marks(run) == {"sample": 120, "forward": 220, "backward": 420, "optimizer": 50}
    assert any(n.startswith("marks: train_sample, ") and "2 of 200 steps without one of each in order" in n
               for n in run.notes)
    run = replays_with_a_clock_jump(50, 20)  # the two steps on either side of the jump: more than MAX_ODD of 50
    assert spans.device_ms(run, "sample") is None
    assert any("2 of 50 steps without one of each in order" in n for n in run.notes)


def test_a_step_that_lacks_a_mark_is_left_out():
    run = replays_with_a_clock_jump(200, 200, lost=[(0, "dyglib_mark_train_sample")])
    assert spans.marks(run) == {"sample": 120, "forward": 220, "backward": 420, "optimizer": 50}
    assert any("1 of 200 steps without one of each in order" in n for n in run.notes)


def test_a_trace_without_spans_or_marks_reads_none():
    run = timeline(drop=None, spans_too=False)
    run.names = ["k" if n.startswith("dyglib_mark_") else n for n in run.names]
    assert spans.host_ms(run, "staging") is None
    assert spans.device_ms(run, "forward") is None
    assert any("span train/staging: 0" in n for n in run.notes)
    assert any(n.startswith("marks: no mark kernel") for n in run.notes)
