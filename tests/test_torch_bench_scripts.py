"""The PyTorch package's benchmark matrix and multi-process benchmark
(``bench_matrix.py``, ``bench_multihost.py``) on the CPU device, held
against the JAX package's ``scripts/bench_matrix.py`` at 1 MiB: each row's
compression ratio equals the JAX script's row of the same method and size,
every round trip is exact, and the multi-process outputs are byte-identical
across process counts (gloo, P in {1, 2})."""

import json
import os
import subprocess
import sys

import pytest
import torch

from fl_rl_compression_mpi_tpu_torch import bench_matrix, bench_multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ["fl-cpu", "fl", "fl-dist", "rl-cpu"]


def _rows(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def matrices(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("matrix")
    jax_out, port_out = str(tmp / "jax.jsonl"), str(tmp / "port.jsonl")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "bench_matrix.py"),
         "--sizes-mb", "1", "--methods", *METHODS, "--reps", "1", "--out",
         jax_out], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert bench_matrix.main(["--device", "cpu", "--sizes-mb", "1",
                              "--methods", *METHODS, "--reps", "1",
                              "--out", port_out]) == 0
    return ({r["method"]: r for r in _rows(jax_out)},
            {r["method"]: r for r in _rows(port_out)})


@pytest.mark.parametrize("method", METHODS)
def test_matrix_row_equals_the_jax_scripts(matrices, method):
    want, got = matrices[0][method], matrices[1][method]
    assert got["ratio"] == want["ratio"]
    assert got["roundtrip_ok"] is True
    assert got["size_mb"] == 1 and got["device"] == "cpu"
    assert got["encode_gbps"] > 0 and got["decode_gbps"] > 0


def test_matrix_reports_a_memory_error_row(tmp_path, monkeypatch):
    def short(n):
        raise MemoryError(f"{n} bytes")

    monkeypatch.setattr(bench_matrix, "check_host_memory", short)
    out = str(tmp_path / "m.jsonl")
    assert bench_matrix.main(["--device", "cpu", "--sizes-mb", "1",
                              "--methods", "rl-cpu", "--out", out]) == 0
    (row,) = _rows(out)
    assert row["error"].startswith("MemoryError")


def test_matrix_without_a_card_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_matrix.main(["--sizes-mb", "1", "--out",
                              str(tmp_path / "m.jsonl")]) == 1


@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("multihost") / "mh.jsonl")
    rc = bench_multihost.main(["--device", "cpu", "--size-mb", "1",
                               "--np-list", "1", "2", "--out", out])
    return rc, _rows(out)


def test_multihost_outputs_are_identical_across_process_counts(multihost):
    rc, rows = multihost
    assert rc == 0
    assert [r["np"] for r in rows] == [1, 2]
    for row in rows:
        assert row["device"] == "cpu"
        assert row["container_identical"] is True
        assert row["roundtrip_ok"] is True


def test_multihost_reads_each_processs_peak_memory(multihost):
    for row in multihost[1]:
        for key in ("maxrss_mb_compress", "maxrss_mb_decompress",
                    "base_rss_mb"):
            assert len(row[key]) == row["np"]
        assert all(mb > 0 for mb in row["maxrss_mb_compress"])
        assert all(mb > 0 for mb in row["base_rss_mb"])


def test_multihost_cuda_rows_need_a_card_each(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_multihost.main(["--size-mb", "1", "--out",
                                 str(tmp_path / "mh.jsonl")]) == 1
