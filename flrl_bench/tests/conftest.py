"""The harness's tests.  Run from the repository root:

    python -m pytest flrl_bench/tests -q            # on the CPU
    python -m pytest flrl_bench/tests -q -m card    # on the card

Tests that need the card carry the ``card`` marker and decide inside the
``cuda`` fixture whether there is one; here they skip.  Everything else
drives the harness on the CPU at small sizes through ``small_root``: a copy
of the benchmark's files whose configurations are cut to 1 MiB files.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips where none is)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def copy_bench(dest: str, file_mib: int = 1) -> str:
    """A checkout's benchmark files under ``dest``, each configuration cut
    to ``file_mib`` MiB; returns the copy's ``flrl_bench`` directory."""
    bench_dir = os.path.join(dest, "flrl_bench")
    shutil.copytree(os.path.join(ROOT, "flrl_bench"), bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(dest, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg["file_mib"] = file_mib
        with open(path, "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench_dir


@pytest.fixture
def small_root(tmp_path):
    """(root, bench_dir) of a 1 MiB copy of the benchmark."""
    return str(tmp_path), copy_bench(str(tmp_path))
