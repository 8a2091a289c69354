"""Whole runs on the CPU at 1 MiB: the result line, the refusal without a
card, the control and the planted faults that ``correct`` must catch, and
that nothing of JAX is loaded."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, copy_bench
from flrl_bench import control, run, spec

CELLS = ["fl-files-mixed-512m", "rl-files-rlmixed-512m",
         "fl-resident-mixed-512m", "fl-nccl-4card-mixed-2048m"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _main(root, bench_dir, workload, seconds=1.0, trace=0, seed=2**33 + 1,
          device="cpu"):
    return run.main(["--workload", workload, "--seed", str(seed),
                     "--seconds", str(seconds), "--trace", str(trace)],
                    root=root, bench_dir=bench_dir, device=device)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line(small_root, capsys, workload, trace):
    root, bench_dir = small_root
    assert _main(root, bench_dir, workload, seconds=2.0, trace=trace) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 2
    cell = spec.cell(workload, root, bench_dir)
    kind = "per_layer" if trace else "end_to_end"
    if not trace:
        # the CPU has no device trace, so only host-clock metrics read;
        # file_p90_ms needs 20 files, which a slow CPU may not finish
        assert set(line["metrics"]) | {"file_p90_ms"} >= {
            m.name for m in cell.metrics if m.kind == kind}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    checks = line["checks"]
    assert all(c["value"] <= c["limit"] == 0 for c in checks.values())
    tail = err.strip().splitlines()[-len(checks):]
    assert tail == [f"check {k} = {c['value']} (limit {c['limit']})"
                    for k, c in checks.items()]


def test_no_card_no_result(small_root, capsys, monkeypatch):
    root, bench_dir = small_root
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _main(root, bench_dir, CELLS[0], device=None) != 0
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert _main(root, bench_dir, CELLS[3], device=None) != 0
    assert capsys.readouterr().out == ""


def test_only_benchmark_files_is_refused(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's folder
    the program is missing, so the run fails and prints no result."""
    copy_bench(str(tmp_path), 512)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "flrl_bench", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def _cell(root, bench_dir, workload):
    return spec.cell(workload, root, bench_dir)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(small_root, workload):
    root, bench_dir = small_root
    cell = _cell(root, bench_dir, workload)
    for seed in (1, 2, 3):
        numbers = control.readings(cell, seed, torch.device("cpu"))
        assert not control.check.correct(numbers)
        assert numbers["container_bytes_wrong"][0] > 0
        assert numbers["decoded_bytes_wrong"][0] > 0


# ---------------------------------------------------------------------------
# faults planted in the timed path, under the harness
# ---------------------------------------------------------------------------

def _armed(real, fault, after=2):
    """``real`` for the warm-up's calls (one a pool file), ``fault``
    after: the fault lies in the window's timed calls."""
    calls = []

    def call(*a, **k):
        calls.append(1)
        return (real if len(calls) <= after else fault)(*a, **k)
    return call


def _flip(a):
    a = np.array(a, copy=True)
    a[a.size // 2] ^= 1
    return a


def _altered_host(api, monkeypatch):
    real = api.compress

    def compress(data, method="fl", **opts):
        c = real(data, method, **opts)
        return type(c)(*(_flip(f) if i == 1 else f for i, f in
                         enumerate((c.bits if hasattr(c, "bits")
                                    else c.counts, c.values))),
                       c.input_size)
    monkeypatch.setattr(api, "compress", _armed(real, compress))


def _half_host(api, monkeypatch):
    real = api.decompress
    monkeypatch.setattr(api, "decompress", _armed(
        real, lambda c, method="fl", **o: real(c, method, **o)[
            :c.input_size // 2]))


def _stale_host(api, monkeypatch):
    real, first = api.compress, []

    def compress(data, method="fl", **opts):
        if not first:
            first.append(real(data, method, **opts))
        return first[0]
    monkeypatch.setattr(api, "compress", compress)


def _altered_resident(dist, monkeypatch):
    real = dist.fl_compress_sharded_dense

    def compress(*a, **k):
        bits, dense, totals = real(*a, **k)
        dense = [d.clone() for d in dense]
        dense[0][0] ^= 1
        return bits, dense, totals
    monkeypatch.setattr(dist, "fl_compress_sharded_dense",
                        _armed(real, compress))


def _half_resident(dist, monkeypatch):
    real = dist.fl_decompress_sharded_dense

    def decompress(*a, **k):
        outs = real(*a, **k)
        return [o[:o.numel() // 2] for o in outs]
    monkeypatch.setattr(dist, "fl_decompress_sharded_dense",
                        _armed(real, decompress))


def _stale_resident(dist, monkeypatch):
    real, first = dist.fl_compress_sharded_dense, []

    def compress(*a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0]
    monkeypatch.setattr(dist, "fl_compress_sharded_dense", compress)


def _no_gather(dist, monkeypatch):
    """The copies from the other cards onto card 0 left out: their parts
    of the merged container stay as the buffer was, zeros."""
    real = dist._gather_on_card

    def gather(dev, parts):
        host = real(dev, parts)
        world = len(parts) // 2
        return [h if i % world == 0 else np.zeros_like(h)
                for i, h in enumerate(host)]
    monkeypatch.setattr(dist, "_gather_on_card", _armed(real, gather))


HOST_FAULTS = {"altered": _altered_host, "half": _half_host,
               "stale": _stale_host}
RESIDENT_FAULTS = {"altered": _altered_resident, "half": _half_resident,
                   "stale": _stale_resident}
FAULTS = ([(w, f) for w in CELLS if "resident" not in w for f in HOST_FAULTS]
          + [("fl-resident-mixed-512m", f) for f in RESIDENT_FAULTS]
          + [("fl-nccl-4card-mixed-2048m", "no_gather")])


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_caught(small_root, monkeypatch, workload, fault):
    from fl_rl_compression_mpi_tpu_torch import api
    from fl_rl_compression_mpi_tpu_torch.parallel import dist
    root, bench_dir = small_root
    if fault == "no_gather":
        _no_gather(dist, monkeypatch)
    elif "resident" in workload:
        RESIDENT_FAULTS[fault](dist, monkeypatch)
    else:
        HOST_FAULTS[fault](api, monkeypatch)
    result = run.run_cell(_cell(root, bench_dir, workload), 77, 0.5, False,
                          0.0, "cpu", log=lambda *a, **k: None,
                          bench_dir=bench_dir)
    assert result["correct"] is False, result["checks"]


# ---------------------------------------------------------------------------
# no JAX
# ---------------------------------------------------------------------------

def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "fl_rl_compression_mpi_tpu_torch.x",
                        sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "fl_rl_compression_mpi_tpu" not in run.loaded_forbidden()
    assert "jax" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "fl_rl_compression_mpi_tpu.ops", sys)
    assert "fl_rl_compression_mpi_tpu" in run.loaded_forbidden()


_NOJAX = """
import json, sys
sys.path.insert(0, sys.argv[1])
from flrl_bench import run
root, bench_dir = sys.argv[2], sys.argv[3]
for w in %r:
    for trace in ("0", "1"):
        rc = run.main(["--workload", w, "--seed", "5", "--seconds", "0.3",
                       "--trace", trace], root=root, bench_dir=bench_dir,
                      device="cpu")
        assert rc == 0, rc
print("MODULES " + json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""" % (CELLS,)


def test_harness_loads_no_jax(small_root):
    root, bench_dir = small_root
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _NOJAX, ROOT, root,
                           bench_dir], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("MODULES ")]
    names = set(json.loads(line[-1][len("MODULES "):]))
    assert "fl_rl_compression_mpi_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "fl_rl_compression_mpi_tpu"}


# ---------------------------------------------------------------------------
# cells a later PR can add with data alone
# ---------------------------------------------------------------------------

LATER = {
    "rl-resident": ({"codec": "rl", "method": "rl"},
                    {"placement": "device", "group_seconds": 0.05},
                    "rlmixed"),
    "rldist-2card": ({"codec": "rl", "method": "rl-dist", "cards": 2,
                      "shards": 2}, {}, "rlmixed"),
    "fl-fields": ({"codec": "fl", "method": "fl",
                   "env": {"FLRL_NO_DENSE": "1"}}, {}, "mixed"),
    "fl-uniform4": ({"codec": "fl", "method": "fl"},
                    {"parts": [{"kind": "uniform", "mib": 512,
                                "width": 4}]}, "mixed"),
}


@pytest.mark.parametrize("name", sorted(LATER))
def test_later_cell_from_data_alone(tmp_path, monkeypatch, name):
    """Each Open-questions cell that needs only a configuration and a traffic
    file runs correct, and a fault in it is caught."""
    monkeypatch.delenv("FLRL_NO_DENSE", raising=False)
    bench_dir = copy_bench(str(tmp_path))
    cfg_over, mix_over, base_mix = LATER[name]
    with open(os.path.join(bench_dir, "configs", "fl-512mb-1card.json")) as f:
        cfg = json.load(f)
    cfg.update(cfg_over)
    with open(os.path.join(bench_dir, "configs", name + ".json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "traffic", base_mix + ".json")) as f:
        mix = json.load(f)
    mix.update(mix_over)
    with open(os.path.join(bench_dir, "traffic", name + ".json"), "w") as f:
        json.dump(mix, f)
    with open(tmp_path / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({"name": name, "source": "x", "why": "x",
                             "file": f"flrl_bench/configs/{name}.json",
                             "reduced": []})
    bench["workloads"].append({"name": name, "config": name,
                               "traffic": name, "chips": cfg["cards"],
                               "why": "x"})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    cell = spec.cell(name, str(tmp_path), bench_dir)
    ok = run.run_cell(cell, 9, 0.3, False, 0.0, "cpu",
                      log=lambda *a, **k: None, bench_dir=bench_dir)
    assert ok["correct"] is True, ok["checks"]
    assert not control.check.correct(
        control.readings(cell, 9, torch.device("cpu")))
