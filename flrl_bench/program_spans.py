"""The arithmetic of the readers of the program's own spans
(``metrics/host_ms.*``, ``idle_host_pct.*``, ``gather_ms.*``).

The program marks each stage of its walks with a ``torch.profiler`` range
(``stage`` in ``fl_rl_compression_mpi_tpu_torch/utils/timers.py``):
``flrl.host.<what>`` for the host's own work, which the card cannot
overlap, ``flrl.h2d.*`` / ``flrl.d2h.*`` for the host side of a copy,
``flrl.kernels``, ``flrl.wait`` and ``flrl.gather.<what>``.  ``digest``
keeps every host range of the traced run in ``run.trace.host``, by name and
on the clock of the device's events, from every thread (a mesh's per-card
threads included).  Each function takes a run and a direction, ``"c"`` or
``"d"``, and returns None where the trace holds no span of the family: a
program that has none gives nothing to read.
"""

from __future__ import annotations

from .trace import clip, length, union


def _calls(run, kind: str) -> int:
    """The traced calls of ``kind``."""
    return sum(g.calls for g in run.groups if g.kind == kind and g.traced)


def _harness(run, kind: str) -> list:
    """The harness's spans of ``kind``, disjoint and sorted."""
    return union((s.start_ns, s.end_ns) for s in run.trace.spans
                 if s.kind == kind)


def within(run, kind: str, family: str):
    """The union, over every thread, of the program's spans whose name
    starts with ``family`` (``"flrl.host."``), clipped to the harness's
    spans of ``kind``: disjoint sorted (start, end) pairs, or None where
    the trace has no such span at all."""
    if run.trace is None:
        return None
    found = union((h.start_ns, h.end_ns) for h in run.trace.host
                  if h.name.startswith(family))
    if not found:
        return None
    return clip(found, _harness(run, kind))


def ms_per_call(run, kind: str, family: str):
    """Milliseconds a traced call of ``kind`` during which a span of
    ``family`` was open on some thread."""
    on = within(run, kind, family)
    calls = _calls(run, kind)
    if on is None or calls == 0:
        return None
    return length(on) / calls / 1e6


def idle_pct(run, kind: str, family: str):
    """Of the time a card ran no kernel, copy or memset inside the harness's
    spans of ``kind``, the share during which a span of ``family`` was open
    on some thread, averaged over the run's cards that were idle at all."""
    on = within(run, kind, family)
    if on is None:
        return None
    spans = _harness(run, kind)
    shares = []
    for card in run.trace.cards:
        busy = union((o.start_ns, o.end_ns) for o in run.trace.ops
                     if o.card == card)
        idle = length(spans) - length(clip(busy, spans))
        if idle > 0:
            shares.append((length(on) - length(clip(on, busy))) / idle)
    return 100.0 * sum(shares) / len(shares) if shares else None
