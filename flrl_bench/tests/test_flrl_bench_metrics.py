"""The readers' arithmetic on synthetic profiler events: rooflines, idle
shares, copy rates, the breakdown, and the host-clock metrics."""

import json

import pytest

from flrl_bench import spec, trace
from flrl_bench.run import Group, Run

MS = 1_000_000


class FakeEvent:
    """What ``digest`` reads of a kineto event."""

    def __init__(self, name, cuda, start, dur, card=0, nbytes=None,
                 annotation=False):
        self._v = (name, cuda, start, dur, card, nbytes, annotation)
        FakeEvent.count += 1
        self.corr = FakeEvent.count

    count = 0

    def correlation_id(self):
        return self.corr

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def device_index(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[6]


class FakeProf:
    def __init__(self, events):
        results = type("K", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()
        self.events = events

    def export_chrome_trace(self, path):
        """The Chrome trace's copy events, as the profiler writes them."""
        cats = {"HtoD": "gpu_memcpy", "DtoH": "gpu_memcpy",
                "memset": "gpu_memset"}
        out = [{"cat": cats[trace.op_kind(e.name())], "name": e.name(),
                "args": {"correlation": e.corr, "bytes": e._v[5]}}
               for e in self.events
               if e._v[1] and trace.op_kind(e.name()) in cats]
        with open(path, "w") as f:
            json.dump({"traceEvents": out}, f)


def _events():
    # a compress span 0-10 ms: 2 ms copy up (1 GB), 1 ms kernel, 1 ms memset
    # on card 0 and a 3 ms kernel on card 1; a decompress span 20-30 ms:
    # a 2 ms kernel and a 4 ms copy down (0.5 GB) on card 0 only
    return [
        FakeEvent("flrl_bench.c", False, 0, 10 * MS),
        FakeEvent("flrl_bench.c", True, 0, 10 * MS, annotation=True),
        FakeEvent("Memcpy HtoD (Pinned -> Device)", True, 1 * MS, 2 * MS,
                  nbytes=10**9),
        FakeEvent("flrl_pack", True, 4 * MS, 1 * MS),
        FakeEvent("Memset (Device)", True, 5 * MS, 1 * MS, nbytes=64),
        FakeEvent("flrl_pack", True, 2 * MS, 3 * MS, card=1),
        FakeEvent("cudaLaunchKernel", False, 3 * MS, 2 * MS),
        FakeEvent("flrl_bench.d", False, 20 * MS, 10 * MS),
        FakeEvent("flrl_unpack", True, 21 * MS, 2 * MS),
        FakeEvent("Memcpy DtoH (Device -> Pageable)", True, 24 * MS, 4 * MS,
                  nbytes=5 * 10**8),
        FakeEvent("aten::copy_", False, 23 * MS, 6 * MS),
        FakeEvent("aten::empty", False, 28 * MS + 500_000, 1 * MS),
    ]


def _run():
    t = trace.digest(FakeProf(_events()), (0, 1))
    cell = spec.cell("fl-files-mixed-512m")
    run = Run(cell, 12.5)
    run.groups = [Group("c", 0, 1, 3_350_000_000, 3_350_000_000, 0.010,
                        True, 0),
                  Group("d", 0, 1, 1_675_000_000, 1_675_000_000, 0.010,
                        True, 0)]
    run.trace = t
    return run


def test_digest_drops_annotations_and_splits_kinds():
    t = _run().trace
    assert [s.kind for s in t.spans] == ["c", "d"]
    assert [o.kind for o in t.ops] == ["HtoD", "kernel", "kernel", "memset",
                                       "kernel", "DtoH"]
    assert t.ops[0].nbytes == 10**9 and t.window_ns == 30 * MS


def test_rooflines():
    run = _run()
    # c: 6.7e9 bytes / 3.35e12 = 2 ms of bound over 1 + 1 + 3 ms of kernels
    # and memsets on both cards
    assert spec.reader("kernels_roofline.c")(run) == pytest.approx(40.0)
    # d: 3.35e9 bytes = 1 ms of bound over 2 ms of kernels
    assert spec.reader("kernels_roofline.d")(run) == pytest.approx(50.0)


def test_idle_shares():
    run = _run()
    # card 0 busy 1-3, 4-6 of 10 ms (idle 0.6); card 1 busy 2-5 (idle 0.7)
    assert spec.reader("device_idle_pct.c")(run) == pytest.approx(65.0)
    # card 0 busy 21-23, 24-28 of 10 ms (idle 0.4); card 1 idle (1.0)
    assert spec.reader("device_idle_pct.d")(run) == pytest.approx(70.0)
    assert trace.busy_seconds(run.trace) == pytest.approx(
        (0.010 + 0.003) / 2)


def test_copy_rates():
    run = _run()
    assert spec.reader("h2d_gbps.c")(run) == pytest.approx(500.0)
    assert spec.reader("d2h_gbps.d")(run) == pytest.approx(125.0)


def test_readers_find_nothing_without_trace_or_copies():
    run = _run()
    run.trace = None
    for name in ("kernels_roofline.c", "device_idle_pct.d", "h2d_gbps.c"):
        assert spec.reader(name)(run) is None
    run = _run()
    run.trace.ops = [o for o in run.trace.ops if not o.copy]
    assert spec.reader("h2d_gbps.c")(run) is None
    assert spec.reader("d2h_gbps.d")(run) is None


def test_breakdown():
    b = trace.breakdown(_run().trace)
    assert b["device_ops"][0] == ["flrl_pack", pytest.approx(0.004)]
    assert len(b["device_ops"]) == 5
    # card 1's whole decompress span (10 ms) is the longest gap, with
    # aten::copy_ at its middle; card 0's last 2 ms of it had aten::empty
    assert b["idle_gaps"][0] == ["aten::copy_", pytest.approx(0.010)]
    # card 1's last 5 ms of the compress span: cudaLaunchKernel had ended
    assert b["idle_gaps"][1] == ["after cudaLaunchKernel",
                                 pytest.approx(0.005)]
    assert ["aten::empty", pytest.approx(0.002)] in b["idle_gaps"]
    json.dumps(b)


def test_host_clock_metrics():
    cell = spec.cell("fl-files-mixed-512m")
    run = Run(cell, 9.0)
    for t in range(30):
        run.groups.append(Group("c", t % 2, 1, 10**9, 5 * 10**8,
                                0.1 + t / 1000, False, t))
        run.groups.append(Group("d", t % 2, 1, 5 * 10**8, 10**9, 0.2, False,
                                t))
    c_wall = sum(0.1 + t / 1000 for t in range(30))
    assert spec.reader("compress_gbps")(run) == pytest.approx(30 / c_wall)
    assert spec.reader("decompress_gbps")(run) == pytest.approx(5.0)
    # round trips 300..329 ms; nearest rank of 0.9 × 30 = 27th: 326 ms
    assert spec.reader("file_p90_ms")(run) == pytest.approx(326.0)
    assert spec.reader("setup_s")(run) == 9.0
    run.groups = run.groups[:10]
    assert spec.reader("file_p90_ms")(run) is None
    run.groups[0].calls = 3
    assert spec.reader("file_p90_ms")(run) is None
