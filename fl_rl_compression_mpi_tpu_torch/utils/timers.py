"""Phase timers + throughput reporting.

Same ``[TIMER] <name>: <ms> ms (<rate>)`` lines and the same
``Timer``/``timed``/``stage``/``set_stage_timers``/``profiler_trace`` API as
``fl_rl_compression_mpi_tpu/utils/timers.py``.  A device stage passes the
tensors it produced in ``result``; the timer then synchronises the CUDA
device before it stops, so the stage's time is the device's time and not
the enqueue's.  Stages that run in a mesh's per-card threads
(``parallel/dist.py``) print each line whole, tagged ``[card i]``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable

import torch

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

    def stop(self, *wait_for) -> float:
        """Stop; when any ``wait_for`` tensor lives on a CUDA device, that
        device is synchronised first so the phase measures finished work."""
        for dev in {x.device for x in wait_for
                    if isinstance(x, torch.Tensor) and x.is_cuda}:
            torch.cuda.synchronize(dev)
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
          result=None, printer: Callable[[str], None] = print):
    """``with timed("compression", nbytes=n): ...`` — prints on exit.
    Pass ``result=[tensor, ...]`` (a list filled inside the block) to
    wait for device work before stopping the clock."""
    t = Timer(name, rank=rank, enabled=enabled, printer=printer)
    if nbytes:
        t.add_transfer_size(nbytes)
    t.start()
    try:
        yield t
    finally:
        t.stop(*(result or ()))
        t.print_result()


# Stage timers: per-stage [TIMER] lines inside the codec (copy in, kernels,
# copy out).  A module-level switch, so the codec pays one bool check when
# they are off.
_STAGE = {"enabled": False, "rank": -1}
# The mesh shard a per-card thread works on (None outside one), and the lock
# that keeps the threads' lines whole.
_CARD = threading.local()
_PRINT_LOCK = threading.Lock()


@contextlib.contextmanager
def card_scope(index: int):
    """Mark this thread as the one that drives shard ``index`` of a mesh:
    its stage lines are tagged ``[card <index>]`` and its kernel launches
    counted under that shard (``fl_dense_cuda.launches_by``)."""
    _CARD.index = index
    try:
        yield
    finally:
        _CARD.index = None


def current_card() -> int | None:
    """The shard of the mesh this thread drives, or None."""
    return getattr(_CARD, "index", None)


def _card_printer(index: int) -> Callable[[str], None]:
    def printer(line: str) -> None:
        with _PRINT_LOCK:
            print(f"[card {index}] {line}", flush=True)
    return printer


def set_stage_timers(enabled: bool, rank: int = -1) -> None:
    """Turn the per-stage ``[TIMER]`` lines inside the codec on or off."""
    _STAGE["enabled"] = bool(enabled)
    _STAGE["rank"] = int(rank)


def stage_timers_enabled() -> bool:
    return _STAGE["enabled"]


@contextlib.contextmanager
def stage(name: str, nbytes: int = 0, result=None):
    """Codec-internal stage timer: a no-op (no synchronise, no print)
    unless :func:`set_stage_timers` turned it on."""
    if not _STAGE["enabled"]:
        yield None
        return
    card = current_card()
    with timed(name, nbytes=nbytes, rank=_STAGE["rank"], enabled=True,
               result=result,
               printer=print if card is None else _card_printer(card)) as t:
        yield t


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Optional ``torch.profiler`` trace around a phase, written to
    ``logdir`` in TensorBoard's format (the JAX package's ``--profile``
    writes a ``jax.profiler`` trace there).  CPU activity, and CUDA
    activity where the machine has a CUDA device; each kernel launch
    shows as a CPU range named after its C entry point (``flrl_*``)."""
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
