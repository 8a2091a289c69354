"""The arithmetic of ``metrics/walk_overlap_pct.*``: how much of the
card's work the FL walk hid behind the host's submit of a later chunk.

The walk (``_pipeline`` in ``fl_rl_compression_mpi_tpu_torch/ops/
fl_torch.py``) submits chunk k + 1 (its stage-in into pinned memory, the
copy up and the kernels' launch) before it drains chunk k (the copy down),
and marks each submit with a ``flrl.walk.submit`` span and each drain with
a ``flrl.walk.drain`` span.  Device work that runs while a submit span is
open ran under the host's work on a later chunk; a one-chunk call has no
later chunk, so it reads near 0.
"""

from __future__ import annotations

from .program_spans import within
from .trace import clip, length, union


def overlap_pct(run, kind: str):
    """Of the time a card ran a kernel, copy or memset inside the harness's
    spans of ``kind``, the share during which a ``flrl.walk.submit`` span
    was open on some thread, averaged over the run's cards that ran
    anything there.  None where the trace has no ``flrl.walk.`` span (a
    program without them) or no card ran anything."""
    if within(run, kind, "flrl.walk.") is None:
        return None
    submits = within(run, kind, "flrl.walk.submit") or []
    spans = union((s.start_ns, s.end_ns) for s in run.trace.spans
                  if s.kind == kind)
    shares = []
    for card in run.trace.cards:
        busy = clip(union((o.start_ns, o.end_ns) for o in run.trace.ops
                          if o.card == card), spans)
        if length(busy) > 0:
            shares.append(length(clip(busy, submits)) / length(busy))
    return 100.0 * sum(shares) / len(shares) if shares else None
