"""Timers of the PyTorch package: the JAX package's line format."""

import numpy as np
import torch

from fl_rl_compression_mpi_tpu.utils import timers as jax_timers
from fl_rl_compression_mpi_tpu_torch.utils.timers import (
    Timer, _format_rate, set_stage_timers, stage, timed)


def test_rate_format_matches_jax_package():
    for nbytes, s in ((5_000_000_000, 1.0), (5_000_000, 1.0), (5_000, 1.0),
                      (5, 1.0), (100, 0.0), (123_456_789, 0.37)):
        assert _format_rate(nbytes, s) == jax_timers._format_rate(nbytes, s)


def test_timer_prints_rank_and_body(capsys):
    t = Timer("load", rank=3).start()
    t.stop(torch.zeros(3))              # a CPU tensor needs no fence
    t.print_result()
    out = capsys.readouterr().out
    assert out.startswith("[Rank 3] [TIMER] load:") and "ms" in out


def test_timed_reports_rate(capsys):
    with timed("phase", nbytes=1 << 20, result=[torch.ones(2)]):
        np.zeros(10)
    out = capsys.readouterr().out
    assert "[TIMER] phase:" in out and "B/s" in out


def test_stage_is_silent_unless_enabled(capsys):
    with stage("Compression", 10) as t:
        assert t is None
    assert capsys.readouterr().out == ""
    set_stage_timers(True, rank=1)
    try:
        with stage("Compression", 10) as t:
            assert t is not None
    finally:
        set_stage_timers(False)
    assert "[Rank 1] [TIMER] Compression:" in capsys.readouterr().out
