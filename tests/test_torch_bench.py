"""The PyTorch package's benchmark (``fl_rl_compression_mpi_tpu_torch.bench``)
on the CPU device, held against the JAX package's ``bench.py`` on the same
sizes: the port's runs in this process (``--device cpu --size-mb 1 --reps
1 --json-only``, then with ``--full``, then ``--method rl``), the JAX
bench's in a process of its own, as a user runs it (its watchdog thread
and alarm outlive ``main``).  The metric, unit and compression ratio must
be equal; every round-trip check of the port's run must hold, no arm may
fail, and an arm that raises or a round trip that fails must make the
exit code nonzero."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fl_rl_compression_mpi_tpu.ops import rl_numpy
from fl_rl_compression_mpi_tpu_torch import bench
from fl_rl_compression_mpi_tpu_torch.ops import fl_torch, rl_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--device", "cpu", "--size-mb", "1", "--reps", "1", "--json-only"]


def _port(argv):
    """``(rc, every JSON line printed)`` of the port's bench in this
    process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv)
    return rc, [json.loads(line) for line in out.getvalue().splitlines()
                if line.startswith("{")]


def _jax(argv):
    """The last JSON line of the JAX package's bench.py."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bench.py"),
                           "--size-mb", "1", "--reps", "1", "--json-only",
                           *argv], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # the dense_bmp arm's image: a 24-bit BMP header and pixels of a
    # smooth gradient, written from a seed
    bmp = tmp_path_factory.mktemp("bmp") / "image.bmp"
    g = np.random.default_rng(7)
    rows = (np.arange(853)[:, None] + np.arange(1280 * 3)[None] // 9) % 256
    pixels = (rows + g.integers(0, 4, rows.shape)).astype(np.uint8)
    bmp.write_bytes(b"BM" + bytes(52) + pixels.tobytes())
    with pytest.MonkeyPatch.context() as mp:
        # the e2e arm's pipelined walk needs more than one chunk of 1 MiB
        mp.setattr(bench, "PIPE_CHUNK", 256 << 10)
        return {"fl": _port(BASE),
                "full": _port(BASE + ["--full", "--bmp", str(bmp)]),
                "rl": _port(BASE + ["--method", "rl"])}


@pytest.mark.parametrize("method", ["fl", "rl"])
def test_metric_unit_and_ratio_equal_the_jax_bench(runs, method):
    rc, lines = runs[method]
    want = _jax(["--method", method])
    assert rc == 0
    got = lines[-1]
    for key in ("metric", "unit", "ratio"):
        assert got[key] == want[key], key
    assert got["value"] > 0 and got["device"] == "cpu"


@pytest.mark.parametrize("run", ["fl", "full"])
def test_every_check_holds_and_no_arm_fails(runs, run):
    rc, lines = runs[run]
    rec = lines[-1]
    assert rc == 0
    assert rec["host_roundtrip_ok"] is True
    dense = [key for key in rec if key.startswith("dense_ok")]
    assert dense and all(rec[key] is True for key in dense), dense
    assert rec["rl_ok"] is True
    assert not [key for key in rec if key.endswith(("_error", "_flag"))]
    assert rec["copy_ceiling_gbps"] > 0 and rec["sharded_eff"] > 0
    assert rec["chain_pack"] in (1, 2) and rec["fold_gbps"] > 0


def test_the_headline_line_comes_first(runs):
    _, lines = runs["fl"]
    first = lines[0]
    assert first["metric"] == "fl_kernel_throughput"
    assert first["value"] == first["chained_pair_gbps"] > 0
    assert "copy_ceiling_gbps" in first and "dense_ok" not in first
    assert set(lines[-1]["skipped_arms"]) == {
        "dense_w3", "dense_mixed", "dense_bmp", "rl_half", "e2e"}


def test_dense_paths_follow_the_production_dispatch(runs):
    rec = runs["full"][1][-1]
    assert rec["dense_path"] == "uniform-w4"
    assert rec["dense_path_zeros"] == "constant-w1"
    assert rec["dense_path_w8"] == "uniform-w8"
    assert rec["dense_path_w3"] == "uniform-w3"
    assert rec["dense_path_mixed"] == "general"


def test_full_runs_the_pipelined_e2e(runs):
    rec = runs["full"][1][-1]
    assert rec["e2e_pipe_ok"] is True
    assert rec["end_to_end_gbps"] > 0 and rec["rl_half_gbps"] > 0
    assert "skipped_arms" not in rec
    assert rec["dense_ok_bmp"] is True and rec["dense_pair_bmp_gbps"] > 0


@pytest.mark.parametrize("path", [None, "absent.bmp"])
def test_dense_bmp_without_its_image_is_skipped_with_a_reason(
        tmp_path, path):
    """The image comes only from ``--bmp``: without one, or where the
    file is absent, the arm is skipped and says why."""
    argv = BASE + ["--full"] + (["--bmp", str(tmp_path / path)]
                                if path else [])
    b = bench.Bench(bench._parser().parse_args(argv), torch.device("cpu"))
    bench.SKIPPED.clear()
    bench.REASONS.clear()
    b.arm_dense_bmp()
    assert bench.SKIPPED == ["dense_bmp"]
    assert bench.REASONS["dense_bmp"] == (
        f"no image at {tmp_path / path}" if path
        else "no image: pass --bmp PATH")


@pytest.mark.parametrize("signum", [0, 15])
def test_a_cut_run_flushes_its_line_and_exits_nonzero(monkeypatch, capsys,
                                                      signum):
    """A signal or the watchdog (signal 0) flushes the JSON so far with
    ``interrupted_error`` and exits 1, since arms were left to run."""
    class Exit(Exception):
        pass

    def exit_(code):
        raise Exit(code)

    monkeypatch.setattr(bench.os, "_exit", exit_)
    monkeypatch.setattr(bench, "RESULT", {"metric": "fl_kernel_throughput",
                                          "value": 1.0})
    with pytest.raises(Exit) as cut:
        bench._flush_and_exit(signum, None)
    assert cut.value.args == (1,)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cause = "watchdog" if signum == 0 else f"signal {signum}"
    assert rec["interrupted_error"].startswith(cause + " at +")


ARMS = ("tune", "perop", "dense_main", "rl", "sharded", "dense_zeros",
        "dense_w8", "rl_zeros", "fold")


@pytest.mark.parametrize("fault", ["raises", "mismatch"])
def test_a_failed_arm_makes_the_exit_code_nonzero(monkeypatch, fault):
    """An arm that raises leaves ``<arm>_error``, a round trip that fails
    a false ``*_ok``; either makes the exit code 1 (the other arms are
    stubbed out to keep the run short)."""
    def boom(*args, **kwargs):
        raise RuntimeError("injected")

    keep = "sharded" if fault == "raises" else "dense_zeros"
    for name in ARMS:
        if name != keep:
            monkeypatch.setattr(bench.Bench, f"arm_{name}",
                                lambda self: None)
    if fault == "raises":
        monkeypatch.setattr(bench.dist, "compress_fl", boom)
    else:
        monkeypatch.setattr(bench, "constant_step",
                            lambda cbyte, fb, n: lambda x: x + 1)
    rc, lines = _port(BASE)
    assert rc == 1
    if fault == "raises":
        assert lines[-1]["sharded_error"] == "RuntimeError"
    else:
        assert lines[-1]["dense_ok_zeros"] is False


def test_without_a_card_it_fails_and_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--size-mb", "1"]) == 1
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cap", [1 << 16, 1 << 30])
def test_rl_method_walks_chunks_like_rl_numpy(monkeypatch, cap):
    """``--method rl``'s device-resident walk, across the chunk cap and
    within it, against the JAX package's NumPy RL codec."""
    monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", cap)
    g = np.random.default_rng(5)
    data = np.repeat(g.integers(0, 4, 9000, np.uint8),
                     g.integers(1, 600, 9000))[:300_000].copy()
    counts, values = bench.rl_encode_device(torch.from_numpy(data), data)
    want_c, want_v = rl_numpy.encode(data)
    np.testing.assert_array_equal(counts.numpy(), want_c)
    np.testing.assert_array_equal(values.numpy(), want_v)
    counts_h = counts.numpy()
    block_end = rl_torch._block_ends(counts_h)
    chunks = list(rl_torch._run_chunks(counts_h, block_end, cap))
    assert (len(chunks) > 1) == (cap < data.size)
    out = bench.rl_decode_device(counts, values, counts_h, block_end)
    np.testing.assert_array_equal(out.numpy(), data)
