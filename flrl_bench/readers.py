"""The arithmetic that the metric readers (``metrics/<name>.py``) share.
Each function takes a run (``run.Run``) and a direction, ``"c"`` for the
compress calls or ``"d"`` for the decompress calls, and returns None where
it finds nothing to read."""

from __future__ import annotations

from .trace import idle_share


def rate_gbps(run, kind: str, field: str):
    """GB/s over every group of ``kind`` in the window: the summed
    ``field`` bytes (``bytes_in`` or ``bytes_out``) over the summed wall."""
    groups = [g for g in run.groups if g.kind == kind]
    wall = sum(g.wall_s for g in groups)
    if wall <= 0:
        return None
    return sum(getattr(g, field) for g in groups) / wall / 1e9


def roofline_pct(run, kind: str):
    """The least time the card could take for the traced calls of ``kind``,
    their bytes (input read once, output written once) over the published
    HBM3 peak, as a share of the summed time of every kernel and memset
    that ran on any card inside those calls' spans."""
    if run.trace is None:
        return None
    ns = sum(o.end_ns - o.start_ns for o in run.trace.within(kind)
             if not o.copy)
    work = sum(g.bytes_in + g.bytes_out for g in run.groups
               if g.kind == kind and g.traced)
    if ns <= 0 or work <= 0:
        return None
    return 100.0 * work / run.peak_bytes_per_s / (ns / 1e9)


def idle_pct(run, kind: str):
    """The share of the traced spans of ``kind`` in which a card ran no
    kernel, copy or memset, averaged over the run's cards."""
    if run.trace is None:
        return None
    share = idle_share(run.trace, kind)
    return None if share is None else 100.0 * share


def copy_gbps(run, kind: str, copy: str):
    """Bytes of the copies of kind ``copy`` (``HtoD``, ``DtoH``) inside the
    traced spans of ``kind`` over those copies' device time, every card."""
    if run.trace is None:
        return None
    ops = [o for o in run.trace.within(kind) if o.kind == copy]
    ns = sum(o.end_ns - o.start_ns for o in ops)
    nbytes = sum(o.nbytes for o in ops)
    return nbytes / ns if ns > 0 and nbytes > 0 else None
