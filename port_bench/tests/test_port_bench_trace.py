"""The trace reduction on a hand-made timeline: busy and idle time, the
gaps outside replays, kernels a step, the kernel functions' shares and
the breakdown."""
import types

from torch.autograd import DeviceType

from port_bench import trace


class Ev:
    def __init__(self, name, start, dur, device=False, corr=0, annotation=False):
        self._v = (name, start, dur, device, corr, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


KERNEL = types.SimpleNamespace(KIND="kernel", ANCHOR=r"query_kernel<Gathered", LEADING=[r"project"],
                               TRAILING=[r"combine"], calls=lambda cell: [(165e3, 0.0)])
MODEL = types.SimpleNamespace(KIND="model", MODEL="M", flops=lambda cfg, phase: 67e3)


def timeline():
    """Window [0, 1000); two sweeps; two replays of [project, query, combine]
    and one copy; an idle stretch between the sweeps."""
    ev = [Ev("bench/window", 0, 1000), Ev("bench/sweep", 0, 400), Ev("bench/sweep", 500, 500),
          Ev("cudaGraphLaunch", 10, 5, corr=1), Ev("cudaGraphLaunch", 600, 5, corr=2),
          Ev("bench/sweep", 0, 400, device=True, annotation=True), Ev("aten::item", 520, 40)]
    for base, c in ((100, 1), (700, 2)):
        ev += [Ev("project", base, 50, True, c), Ev("query_kernel<GatheredLoader>", base + 50, 100,
                                                    True, c),
               Ev("combine", base + 160, 40, True, c)]
    ev.append(Ev("Memcpy HtoD", 350, 20, True, 0))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: ev)))
    cell = {"cfg": {"model": "M", "peak": {"flops_per_s": 67e12}}}
    return trace.from_profiler(prof, "train", cell, 2, {"q": KERNEL, "m": MODEL})


def test_busy_idle_and_gaps():
    run = timeline()
    assert run.window == (0, 1000) and len(run.sweeps) == 2
    # busy: [100,250) [260,300) [350,370) [700,850) [860,900) = 400 ns; the
    # annotation is not work
    assert run.busy_ns() == 400
    assert abs(trace.idle_share(run) - 60.0) < 1e-9
    assert run.idle()[:3] == [(0, 100), (250, 260), (300, 350)]
    # outside the replays' envelopes [100,300) and [700,900) and the copy
    assert abs(trace.sweep_gap_ms(run) - 580 / 2 / 1e6) < 1e-15
    assert trace.kernels_per_step(run) == 3.0


def test_kernel_shares_and_mfu():
    run = timeline()
    least, dev = trace.kernel_shares(run)["q"]
    assert abs(least - 2e-9) < 1e-21  # 165e3 products at 165 T/s, two steps
    assert abs(dev - 380e-9) < 1e-21  # both calls' three kernels
    assert abs(trace.kernels_roofline(run) - 100 * 2 / 380) < 1e-9
    assert abs(trace.mfu(run) - 100 * 67e3 * 2 / 1e-6 / 67e12) < 1e-9


def test_a_function_missing_from_the_trace_is_left_out():
    run = timeline()
    run.work = {"q": KERNEL, "other": types.SimpleNamespace(
        KIND="kernel", ANCHOR="absent_kernel", calls=lambda cell: [(1.0, 1.0)])}
    assert set(trace.kernel_shares(run)) == {"q"}
    assert any("other" in n for n in run.notes)


def test_breakdown_names_ops_and_gaps():
    b = trace.breakdown(timeline())
    assert b["device_ops"][0] == ["query_kernel<GatheredLoader>", 200e-9]
    assert len(b["device_ops"]) == 4 and len(b["idle_gaps"]) <= trace.GAP_LIST
    gap, what = max((g[1], g[0]) for g in b["idle_gaps"])
    assert abs(gap - 330e-9) < 1e-18 and what == "aten::item"  # (370, 700)
