"""Timers of the PyTorch package: the JAX package's line format, and the
three states of a codec stage (off, a profiler's span, a ``[TIMER]``
line) with no synchronise in any."""

import re
import threading

import numpy as np
import pytest
import torch

import torch_spans
import fl_rl_compression_mpi_tpu_torch as flrl
from fl_rl_compression_mpi_tpu.utils import timers as jax_timers
from fl_rl_compression_mpi_tpu_torch.cli import main
from fl_rl_compression_mpi_tpu_torch.models import registry
from fl_rl_compression_mpi_tpu_torch.utils import thread_state, timers
from fl_rl_compression_mpi_tpu_torch.utils.timers import (
    Timer, _format_rate, card_scope, set_stage_timers, stage, timed)

CPU = torch.device("cpu")
LINE = re.compile(r"^(\[card \d\] )?(\[Rank \d\] )?\[TIMER\] ([^:]+): "
                  r"[0-9]+\.[0-9]{3} ms( \([0-9.]+ [KMG]?B/s\))?$")


def test_rate_format_matches_jax_package():
    for nbytes, s in ((5_000_000_000, 1.0), (5_000_000, 1.0), (5_000, 1.0),
                      (5, 1.0), (100, 0.0), (123_456_789, 0.37)):
        assert _format_rate(nbytes, s) == jax_timers._format_rate(nbytes, s)


def test_timer_prints_rank_and_body(capsys):
    t = Timer("load", rank=3).start()
    t.stop()
    t.print_result()
    out = capsys.readouterr().out
    assert out.startswith("[Rank 3] [TIMER] load:") and "ms" in out


def test_timed_reports_rate(capsys):
    with timed("phase", nbytes=1 << 20):
        np.zeros(10)
    out = capsys.readouterr().out
    assert "[TIMER] phase:" in out and "B/s" in out


def test_stage_is_silent_unless_enabled(capsys):
    with stage("Compression", 10, span="flrl.kernels") as t:
        assert t is None
    assert capsys.readouterr().out == ""
    set_stage_timers(True, rank=1)
    try:
        with stage("Compression", 10, span="flrl.kernels") as t:
            assert t is not None
    finally:
        set_stage_timers(False)
    assert "[Rank 1] [TIMER] Compression:" in capsys.readouterr().out


def _refuse(monkeypatch, *, ranges: bool):
    """Make every synchronise (and, with ``ranges``, every profiler range,
    CUDA event and use of the thread-state library) raise."""
    def boom(*_, **__):
        raise AssertionError("called in a state that must not call it")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", boom)
    if ranges:
        monkeypatch.setattr(torch.profiler, "record_function", boom)
        monkeypatch.setattr(torch.cuda, "Event", boom)
        monkeypatch.setattr(thread_state, "_lib", boom)


def _round_trips(monkeypatch):
    """fl and rl round trips on the CPU, one device and a three-card mesh
    of CPU shards."""
    monkeypatch.setattr(registry, "default_device", lambda: CPU)
    data = torch_spans.stream(60_000)
    for method, opts in (("fl", {}), ("rl", {}), ("fl-ici", {"devices": 3}),
                         ("rl-dist", {"devices": 3})):
        comp = flrl.compress(data, method=method, **opts)
        np.testing.assert_array_equal(
            flrl.decompress(comp, method=method, **opts), data)


def test_off_enters_no_range_and_waits_on_nothing(monkeypatch, capsys):
    """With no profiler and no --timers a stage enters no profiler range,
    makes no CUDA event and calls no synchronise, in every form and
    through whole round trips."""
    _refuse(monkeypatch, ranges=True)
    for kw in ({}, {"on": CPU}, {"on": None}):
        with stage("Compression", 10, span="flrl.kernels", **kw) as t:
            assert t is None
        with stage(span="flrl.host.probe", **kw) as t:
            assert t is None
    assert stage(span="flrl.wait") is stage("Decompression",
                                            span="flrl.kernels")
    _round_trips(monkeypatch)
    assert capsys.readouterr().out == ""


def test_profiler_state_calls_no_synchronise(monkeypatch):
    """Under a profiler a stage only enters its span."""
    _refuse(monkeypatch, ranges=False)
    with torch_spans.spans() as got:
        _round_trips(monkeypatch)
    assert len({r.thread for r in got}) > 1
    torch_spans.check(got)


_FL_C = ["Copy input data to device", "Compression", "Copy results to CPU"]
_FL_D = ["Copy input to device", "Decompression", "Copy results to CPU"]


def test_timer_lines_keep_format_tags_and_order(tmp_path, monkeypatch,
                                                capsys):
    """Under --timers every line keeps the reference's format and the
    stage order of a walk, the CLI's phase lines after the stages they
    hold, and no stage synchronises."""
    _refuse(monkeypatch, ranges=False)
    monkeypatch.setattr(registry, "default_device", lambda: CPU)
    data = torch_spans.stream(60_000)
    set_stage_timers(True, rank=2)
    try:
        flrl.decompress(flrl.compress(data, method="fl"), method="fl")
        lib = capsys.readouterr().out.splitlines()
        flrl.decompress(flrl.compress(data, method="rl"), method="rl")
        rl = capsys.readouterr().out.splitlines()
    finally:
        set_stage_timers(False)
    for lines in (lib, rl):
        assert all(LINE.match(line) and line.startswith("[Rank 2] ")
                   for line in lines), lines
    names = [LINE.match(line).group(3) for line in lib]
    assert names == _FL_C + _FL_D
    assert [LINE.match(line).group(3) for line in rl] == _FL_C + _FL_D
    src, comp = str(tmp_path / "in.bin"), str(tmp_path / "c.fl")
    data.tofile(src)
    assert main(["c", "fl", src, comp, "--timers"]) == 0
    cli = capsys.readouterr().out.splitlines()
    assert all(LINE.match(line) for line in cli), cli
    assert [LINE.match(line).group(3) for line in cli] == [
        "loading input", *_FL_C, "compression", "saving output"]


class _FakeEvent:
    """A CUDA event on the CPU: passes when the test says so."""

    made: list = []

    def __init__(self, enable_timing=False):
        self.passed = False
        self.waits = 0
        _FakeEvent.made.append(self)

    def record(self, stream=None):
        pass

    def query(self):
        return self.passed

    def synchronize(self):
        self.waits += 1
        self.passed = True

    def elapsed_time(self, end):
        return 2.5


@pytest.fixture
def fake_device(monkeypatch):
    """Device stages on the CPU: a fake stream for every ``on``, fake
    events, and stage lines on."""
    _FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(timers, "_stream_of",
                        lambda on: None if on is None else "stream")
    set_stage_timers(True)
    yield _FakeEvent.made
    set_stage_timers(False)


def test_device_lines_wait_in_order(fake_device, capsys):
    """A device stage's line waits until its end event has passed, and the
    lines after it wait behind it; a phase's end prints what is left, in
    order, before its own line.  Only that end waits on an event."""
    with timed("phase"):
        with stage("A", 8, span="flrl.kernels", on="card"):
            pass
        with stage("B", span="flrl.host.layout"):
            pass
        assert capsys.readouterr().out == ""
        fake_device[1].passed = True          # A's end event
        with stage("C", span="flrl.wait"):
            pass
        first = capsys.readouterr().out.splitlines()
        with stage("D", span="flrl.kernels", on="card"):
            pass
        assert capsys.readouterr().out == ""
    assert [LINE.match(line).group(3) for line in first] == ["A", "B", "C"]
    assert first[0] == "[TIMER] A: 2.500 ms (3.20 KB/s)"
    assert [LINE.match(line).group(3)
            for line in capsys.readouterr().out.splitlines()] == ["D",
                                                                 "phase"]
    assert [e.waits for e in fake_device] == [0, 0, 0, 1]


def test_card_threads_lines_join_one_queue(fake_device, capsys):
    """Card threads' lines join the one queue of waiting lines, tagged by
    card, in the order their stages ended; the thread that started them
    prints them once their events pass, before its own line."""
    order = threading.Semaphore(0)

    def card(i):
        if i == 0:
            order.acquire()                   # card 1's stage ends first
        with card_scope(i), stage("Compression", span="flrl.kernels",
                                  on="card"):
            pass
        if i == 1:
            order.release()

    workers = [threading.Thread(target=card, args=(i,)) for i in (0, 1)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=30)
        assert not w.is_alive()
    assert capsys.readouterr().out == ""
    for e in fake_device:
        e.passed = True
    with stage("Copy results to CPU", span="flrl.gather.d2h"):
        pass
    lines = capsys.readouterr().out.splitlines()
    assert all(LINE.match(line) for line in lines), lines
    assert [LINE.match(line).group(1) for line in lines] == [
        "[card 1] ", "[card 0] ", None]
    assert LINE.match(lines[2]).group(3) == "Copy results to CPU"
    assert [e.waits for e in fake_device] == [0, 0, 0, 0]
