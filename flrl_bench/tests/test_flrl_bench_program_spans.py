"""The readers of the program's own spans (``program_spans.py``,
``metrics/host_ms.*``, ``idle_host_pct.*``, ``gather_ms.c``) on
synthetic profiler events: the trace of ``test_flrl_bench_metrics`` with
the program's ``flrl.*`` ranges added, from more than one thread."""

import json

import pytest

from flrl_bench import spec, trace
from flrl_bench.run import Group, Run
from test_flrl_bench_metrics import MS, FakeEvent, FakeProf, _events

US = MS // 1000


def _spans():
    # compress span 0-10 ms: probe and stage-in overlap (two threads, union
    # 0.2-1.5), layout 6.5-8, an output span past the span's end (9-11,
    # 1 ms inside), the launch and a gather, which are not host work;
    # decompress span 20-30 ms: the split 20-21.5, the output 28-29.5
    return [
        FakeEvent("flrl.host.probe", False, 200 * US, 600 * US),
        FakeEvent("flrl.host.stage_in", False, 500 * US, 1 * MS),
        FakeEvent("flrl.kernels", False, 3500 * US, 1 * MS),
        FakeEvent("flrl.host.layout", False, 6500 * US, 1500 * US),
        FakeEvent("flrl.gather.d2h", False, 8 * MS, 1500 * US),
        FakeEvent("flrl.host.out", False, 9 * MS, 2 * MS),
        FakeEvent("flrl.host.split", False, 20 * MS, 1500 * US),
        FakeEvent("flrl.host.out", False, 28 * MS, 1500 * US),
    ]


def _run(events=None, calls=1):
    events = _events() + _spans() if events is None else events
    run = Run(spec.cell("fl-nccl-4card-mixed-2048m"), 20.0)
    run.groups = [Group("c", 0, calls, 1, 1, 0.010, True, 0),
                  Group("d", 0, calls, 1, 1, 0.010, True, 0),
                  Group("c", 1, 5, 1, 1, 0.050, False, 1)]
    run.trace = trace.digest(FakeProf(events), (0, 1))
    return run


def _read(name, run):
    return spec.reader(name)(run)


def test_host_ms():
    # c: 1.3 + 1.5 + 1.0 ms of host spans in one traced call (the untraced
    # group's calls are not counted); d: 1.5 + 1.5
    assert _read("host_ms.c", _run()) == pytest.approx(3.8)
    assert _read("host_ms.d", _run()) == pytest.approx(3.0)
    assert _read("host_ms.c", _run(calls=2)) == pytest.approx(1.9)


def test_gather_ms():
    assert _read("gather_ms.c", _run()) == pytest.approx(1.5)


def test_idle_host_pct():
    # c, card 0 idle 0-1, 3-4, 6-10 (6 ms), host spans in it 0.2-1, 6.5-8,
    # 9-10 (3.3 ms); card 1 idle 0-2, 5-10 (7 ms), host 3.8 ms
    assert _read("idle_host_pct.c", _run()) == pytest.approx(
        100 * (3.3 / 6 + 3.8 / 7) / 2)
    # d, card 0 idle 20-21, 23-24, 28-30 (4 ms), host 20-21, 28-29.5;
    # card 1 idle all 10 ms, host 3 ms
    assert _read("idle_host_pct.d", _run()) == pytest.approx(
        100 * (2.5 / 4 + 3.0 / 10) / 2)


def test_every_reading_stays_in_its_range():
    run = _run()
    for kind in ("c", "d"):
        wall_ms = 1e3 * sum(g.wall_s for g in run.groups
                            if g.kind == kind and g.traced)
        assert 0 <= _read(f"host_ms.{kind}", run) <= wall_ms
        assert 0 <= _read(f"idle_host_pct.{kind}", run) <= 100


def test_none_without_trace_or_spans():
    names = ("host_ms.c", "host_ms.d", "idle_host_pct.c", "idle_host_pct.d",
             "gather_ms.c")
    run = _run()
    run.trace = None
    assert [_read(n, run) for n in names] == [None] * 5
    # a program with no spans of its own (an older commit)
    run = _run(_events())
    assert [_read(n, run) for n in names] == [None] * 5
    # host spans but no gather
    run = _run(_events() + [e for e in _spans()
                            if not e.name().startswith("flrl.gather.")])
    assert _read("gather_ms.c", run) is None
    assert _read("host_ms.c", run) == pytest.approx(3.8)


def test_breakdown_names_a_gap_by_the_host_span_at_its_middle():
    b = trace.breakdown(_run().trace)
    # card 1's last 5 ms of the compress span, whose middle (7.5 ms) lies in
    # the layout span: "after cudaLaunchKernel" without the program's spans
    assert b["idle_gaps"][1] == ["flrl.host.layout", pytest.approx(0.005)]
    assert b["idle_gaps"][0] == ["aten::copy_", pytest.approx(0.010)]
    json.dumps(b)
