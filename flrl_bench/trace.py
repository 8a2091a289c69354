"""The traced run's record: the device's operations and the benchmark's own
spans, read from ``torch.profiler`` and reduced to what the per-layer
readers need.

Spans are the benchmark's: ``flrl_bench.c`` around each timed group of
compress calls and ``flrl_bench.d`` around each group of decompress calls
(``torch.profiler.record_function``, only in a traced run).  Every call
ends with its result on the host or a device synchronise, so the device
work that a group caused lies inside its span.  Device events are the
kernels, copies and memsets that CUPTI recorded, each on its card, with
the bytes of each copy; the span annotations that the profiler also
places on the device's timeline are not device work and are dropped.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass

SPAN_NAMES = {"flrl_bench.c": "c", "flrl_bench.d": "d"}


@dataclass(frozen=True)
class DeviceOp:
    name: str
    kind: str            # kernel, memset, HtoD, DtoH, DtoD or PtoP
    card: int
    start_ns: int
    end_ns: int
    nbytes: int          # copies and memsets; 0 where not recorded

    @property
    def copy(self) -> bool:
        return self.kind in ("HtoD", "DtoH", "DtoD", "PtoP")


@dataclass(frozen=True)
class HostOp:
    name: str
    start_ns: int
    end_ns: int


@dataclass(frozen=True)
class Span:
    kind: str            # "c" | "d"
    start_ns: int
    end_ns: int


@dataclass
class Trace:
    ops: list            # DeviceOp, by start
    host: list           # HostOp
    spans: list          # Span, by start
    cards: tuple         # the indices of the cards the run uses

    def within(self, kind: str) -> list:
        """The device ops that start inside a span of ``kind``."""
        spans = [s for s in self.spans if s.kind == kind]
        out, j = [], 0
        for op in self.ops:
            while j < len(spans) and spans[j].end_ns < op.start_ns:
                j += 1
            if j < len(spans) and spans[j].start_ns <= op.start_ns:
                out.append(op)
        return out

    def span_ns(self, kind: str) -> int:
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if s.kind == kind)

    @property
    def window_ns(self) -> int:
        if not self.spans:
            return 0
        return self.spans[-1].end_ns - self.spans[0].start_ns


def op_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        for kind in ("HtoD", "DtoH", "DtoD", "PtoP"):
            if kind in name:
                return kind
        return "DtoD"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def copy_bytes(prof) -> dict:
    """{correlation id: bytes} of the trace's copies and memsets.  The
    profiler's events do not carry a copy's size; its Chrome trace does
    (``args.bytes``), so the trace is written to a temporary file, read and
    deleted."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    out = {}
    for e in events:
        if e.get("cat") in ("gpu_memcpy", "gpu_memset"):
            args = e.get("args", {})
            if "correlation" in args and "bytes" in args:
                out[int(args["correlation"])] = int(args["bytes"])
    return out


def digest(prof, cards) -> Trace:
    """The Trace of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    ops, host, spans, corr = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name in SPAN_NAMES:
                continue
            ops.append(DeviceOp(name, op_kind(name), e.device_index(),
                                start, start + dur, 0))
            corr.append(e.correlation_id())
        elif name in SPAN_NAMES:
            spans.append(Span(SPAN_NAMES[name], start, start + dur))
        else:
            host.append(HostOp(name, start, start + dur))
    if any(o.kind in ("HtoD", "DtoH") for o in ops):
        sizes = copy_bytes(prof)
        ops = [DeviceOp(o.name, o.kind, o.card, o.start_ns, o.end_ns,
                        sizes.get(c, 0)) if o.kind != "kernel" else o
               for o, c in zip(ops, corr)]
    ops.sort(key=lambda o: o.start_ns)
    spans.sort(key=lambda s: s.start_ns)
    return Trace(ops, host, spans, tuple(cards))


# ---------------------------------------------------------------------------
# arithmetic on intervals, shared by the readers and the breakdown
# ---------------------------------------------------------------------------

def union(intervals) -> list:
    """Disjoint, sorted (start, end) pairs covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, spans) -> list:
    """The parts of disjoint sorted ``intervals`` inside disjoint sorted
    ``spans``."""
    out, j = [], 0
    for a, b in intervals:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            lo, hi = max(a, spans[k][0]), min(b, spans[k][1])
            if lo < hi:
                out.append((lo, hi))
            k += 1
    return out


def length(intervals) -> int:
    return sum(b - a for a, b in intervals)


def busy(trace: Trace, card: int, kind: str | None = None) -> int:
    """Nanoseconds in which card ``card`` ran any operation, within the
    spans of ``kind`` (all spans when None)."""
    spans = union((s.start_ns, s.end_ns) for s in trace.spans
                  if kind is None or s.kind == kind)
    on = union((o.start_ns, o.end_ns) for o in trace.ops if o.card == card)
    return length(clip(on, spans))


def idle_share(trace: Trace, kind: str) -> float | None:
    """The share of ``kind``'s spans in which a card ran nothing, averaged
    over the run's cards; None with no such span."""
    total = trace.span_ns(kind)
    if total <= 0 or not trace.cards:
        return None
    return sum(1 - busy(trace, c, kind) / total
               for c in trace.cards) / len(trace.cards)


def busy_seconds(trace: Trace) -> float:
    """Seconds of the traced window in which a card ran an operation,
    averaged over the run's cards."""
    return sum(busy(trace, c) for c in trace.cards) / len(trace.cards) / 1e9


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name, over
    every card), and the longest idle gaps inside the spans, each named by
    the innermost host operation that ran at its middle, or where none ran
    then, by the last one that had ended ("after ...")."""
    by_name: dict = {}
    for o in trace.ops:
        by_name[o.name] = by_name.get(o.name, 0) + (o.end_ns - o.start_ns)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = union((s.start_ns, s.end_ns) for s in trace.spans)
    gaps = []
    for c in trace.cards:
        on = union((o.start_ns, o.end_ns) for o in trace.ops if o.card == c)
        inside = clip(on, spans)
        edges = [(a, b) for a, b in spans]
        # the gaps are the spans less the busy intervals
        for a, b in edges:
            t = a
            for lo, hi in inside:
                if hi <= a or lo >= b:
                    continue
                if lo > t:
                    gaps.append((lo - t, t, lo))
                t = max(t, hi)
            if b > t:
                gaps.append((b - t, t, b))
    gaps.sort(reverse=True)
    by_end = sorted(trace.host, key=lambda h: h.end_ns)
    ends = [h.end_ns for h in by_end]
    named = []
    for size, a, b in gaps[:top]:
        mid = (a + b) // 2
        covering = [h for h in trace.host if h.start_ns <= mid < h.end_ns]
        if covering:
            name = min(covering, key=lambda h: h.end_ns - h.start_ns).name
        else:
            i = bisect.bisect_right(ends, mid)
            name = "after " + by_end[i - 1].name if i else "(no host op)"
        named.append([name, size / 1e9])
    return {"device_ops": [[n, ns / 1e9] for n, ns in device_ops],
            "idle_gaps": named}
