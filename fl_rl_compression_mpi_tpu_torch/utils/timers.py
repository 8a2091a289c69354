"""Phase timers, throughput reporting, and the codec's stage spans.

Same ``[TIMER] <name>: <ms> ms (<rate>)`` lines and the same
``Timer``/``timed``/``stage``/``set_stage_timers``/``profiler_trace`` API as
``fl_rl_compression_mpi_tpu/utils/timers.py``.

:func:`stage` marks one stage of a codec walk (a copy, the kernels' launch,
a piece of host work) and is in one of three states:

* **off** (no profiler, no ``--timers``): it checks a module flag and
  ``torch.autograd._profiler_enabled()``, and does nothing else;
* **under a profiler**: it enters ``torch.profiler.record_function`` with
  the stage's span name (``flrl.host.<what>``, ``flrl.h2d.pinned``,
  ``flrl.kernels``, ``flrl.wait``, ``flrl.gather.<what>``, and around
  each chunk's submit and drain ``flrl.walk.submit`` / ``.drain``...), a
  range on the profiler's clock, the one the device's events use;
  ``--profile``'s TensorBoard trace and the benchmark's traced runs carry
  these spans;
* **under** ``--timers`` (:func:`set_stage_timers`): it prints the stage's
  ``[TIMER]`` line.  A host stage is timed by ``time.perf_counter``; a
  device stage (``on=`` the stream its work is enqueued on, or the device
  whose current stream that is) by a pair of CUDA events on that stream,
  and its line waits, in order behind the lines before it, until its end
  event has passed: at a later stage's end or at the end of a
  :func:`timed` phase, where the walk's results are on the host.  No stage
  synchronises the device, so the walk keeps its overlap.

Stages that run in a mesh's per-card threads (``parallel/dist.py``,
:func:`card_scope`) join the same queue of lines, each tagged
``[card i]``, and hold the profiler's thread-local state of the thread
that started them, so that their spans reach the trace.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable

import torch

from . import thread_state

_UNITS = [("GB/s", 1e9), ("MB/s", 1e6), ("KB/s", 1e3), ("B/s", 1.0)]


def _format_rate(bytes_: int, seconds: float) -> str:
    if seconds <= 0:
        return "n/a"
    rate = bytes_ / seconds
    for unit, scale in _UNITS:
        if rate >= scale:
            return f"{rate / scale:.2f} {unit}"
    return f"{rate:.2f} B/s"


class Timer:
    """Start/stop phase timer printing ``[TIMER] <name>: <ms> ms``, with a
    ``[Rank N]`` prefix when ``rank`` >= 0."""

    def __init__(self, name: str, rank: int = -1, enabled: bool = True,
                 printer: Callable[[str], None] = print):
        self.name = name
        self.rank = rank
        self.enabled = enabled
        self.printer = printer
        self._t0 = 0.0
        self.elapsed_s = 0.0
        self.transfer_bytes = 0

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        self.elapsed_s = time.perf_counter() - self._t0
        return self.elapsed_s

    def add_transfer_size(self, nbytes: int) -> None:
        """Accumulate bytes for throughput reporting."""
        self.transfer_bytes += int(nbytes)

    def print_result(self) -> None:
        if not self.enabled:
            return
        prefix = f"[Rank {self.rank}] " if self.rank >= 0 else ""
        line = f"{prefix}[TIMER] {self.name}: {self.elapsed_s * 1e3:.3f} ms"
        if self.transfer_bytes:
            line += f" ({_format_rate(self.transfer_bytes, self.elapsed_s)})"
        self.printer(line)


@contextlib.contextmanager
def timed(name: str, nbytes: int = 0, enabled: bool = True, rank: int = -1,
          printer: Callable[[str], None] = print):
    """``with timed("compression", nbytes=n): ...`` — a whole phase that
    ends on the host, timed by the host clock; prints on exit, after the
    phase's own stage lines."""
    t = Timer(name, rank=rank, enabled=enabled, printer=printer)
    if nbytes:
        t.add_transfer_size(nbytes)
    t.start()
    try:
        yield t
    finally:
        t.stop()
        _print_lines(wait=True)
        t.print_result()


# Stage timers: per-stage [TIMER] lines inside the codec.  A module-level
# switch, so that with it off and no profiler a stage costs two checks.
_STAGE = {"enabled": False, "rank": -1}
# Per thread: the mesh shard it works on (``index``, None outside one).
_LOCAL = threading.local()
# The [TIMER] lines not printed yet, from every thread, in the order their
# stages ended: (timer, start event, end event), the events None for a
# host stage.  The lock guards the list and keeps the lines whole.
_PENDING: list = []
_PRINT_LOCK = threading.Lock()


def _print_lines(wait: bool = False) -> None:
    """Print the waiting lines, in order, up to the first whose device
    stage has not ended (every one with ``wait``, where the caller holds
    the walk's results on the host, so that their events have passed)."""
    with _PRINT_LOCK:
        while _PENDING:
            t, start, end = _PENDING[0]
            if end is not None:
                if not end.query():
                    if not wait:
                        return
                    end.synchronize()
                t.elapsed_s = start.elapsed_time(end) / 1e3
            del _PENDING[0]
            t.print_result()


@contextlib.contextmanager
def card_scope(index: int, state=None):
    """Mark this thread as the one that drives shard ``index`` of a mesh:
    its stage lines are tagged ``[card <index>]`` and its kernel launches
    counted under that shard (``fl_dense_cuda.launches_by``).  ``state``
    (``thread_state.capture()`` in the thread that started this one) is
    held for the block, so that its spans reach the profiler's trace."""
    _LOCAL.index = index
    try:
        with thread_state.entered(state):
            yield
    finally:
        _LOCAL.index = None


def current_card() -> int | None:
    """The shard of the mesh this thread drives, or None."""
    return getattr(_LOCAL, "index", None)


def _card_printer(index: int) -> Callable[[str], None]:
    return lambda line: print(f"[card {index}] {line}", flush=True)


def set_stage_timers(enabled: bool, rank: int = -1) -> None:
    """Turn the per-stage ``[TIMER]`` lines inside the codec on or off."""
    _STAGE["enabled"] = bool(enabled)
    _STAGE["rank"] = int(rank)


def stage_timers_enabled() -> bool:
    return _STAGE["enabled"]


_OFF = contextlib.nullcontext()


def stage(name: str | None = None, nbytes: int = 0, *, span: str, on=None):
    """One stage of a codec walk: ``with stage("Compression", n,
    span="flrl.kernels", on=stream): ...``.

    ``span`` is the range's name under a profiler; ``name`` the ``[TIMER]``
    line's (None: the stage prints no line); ``on`` the CUDA stream that
    the stage's device work is enqueued on, or a device whose current
    stream it is (None, or the CPU: a host stage).  The block gets the
    stage's :class:`Timer` where it prints a line (for
    ``add_transfer_size``), else None."""
    timers = _STAGE["enabled"] and name is not None
    if not timers and not torch.autograd._profiler_enabled():
        return _OFF
    return _Stage(name if timers else None, nbytes, span, on)


class _Stage:
    """A stage under a profiler or ``--timers`` (see :func:`stage`)."""

    __slots__ = ("name", "nbytes", "span", "on", "range", "timer", "start",
                 "stream")

    def __init__(self, name, nbytes, span, on):
        self.name, self.nbytes, self.span, self.on = name, nbytes, span, on
        self.range = self.timer = self.start = self.stream = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.span)
            self.range.__enter__()
        if self.name is None:
            return None
        card = current_card()
        self.timer = t = Timer(self.name, rank=_STAGE["rank"],
                               printer=(print if card is None
                                        else _card_printer(card)))
        if self.nbytes:
            t.add_transfer_size(self.nbytes)
        self.stream = _stream_of(self.on)
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        else:
            t.start()
        return t

    def __exit__(self, *exc):
        if self.timer is not None:
            if self.stream is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(self.stream)
                line = (self.timer, self.start, end)
            else:
                self.timer.stop()
                line = (self.timer, None, None)
            with _PRINT_LOCK:
                _PENDING.append(line)
            _print_lines()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def _stream_of(on):
    """The CUDA stream a device stage's events go on, or None."""
    if on is None or isinstance(on, torch.cuda.Stream):
        return on
    on = torch.device(on)
    return torch.cuda.current_stream(on) if on.type == "cuda" else None


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Optional ``torch.profiler`` trace around a phase, written to
    ``logdir`` in TensorBoard's format (the JAX package's ``--profile``
    writes a ``jax.profiler`` trace there).  CPU activity, and CUDA
    activity where the machine has a CUDA device; each kernel launch
    shows as a CPU range named after its C entry point (``flrl_*``), and
    each stage of the walks as a span (``flrl.*``, :func:`stage`), the
    mesh's card threads included."""
    if logdir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
