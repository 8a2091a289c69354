"""The benchmark's pieces are found by name, BENCHMARK.json keeps to its
contract, and a new cell needs new files and entries only."""

import hashlib
import json
import os
import re

import pytest

from conftest import ROOT, copy_bench
from flrl_bench import spec, traffic

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    cell = spec.cell(workload)
    assert cell.workload == workload
    assert cell.config.codec in spec.CODECS
    assert cell.traffic.placement in traffic.PLACEMENTS
    assert cell.chips == cell.config.cards
    kinds = {m.kind for m in cell.metrics}
    assert kinds == {"end_to_end", "per_layer"}
    names = [m.name for m in cell.metrics]
    assert "setup_s" in names
    assert {m.name for m in cell.metrics if m.kind == "per_layer"}


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found_by_name(name):
    assert callable(spec.reader(name))


def test_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["flrl_bench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS + METRICS
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("flrl_bench/configs/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    assert len({c["source"] for c in BENCH["configs"]}) == len(
        BENCH["configs"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(WORKLOADS) // 4)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        for w in m.get("workloads", WORKLOADS):
            cell = spec.cell(w)
            assert m["moves"] in [x.name for x in cell.metrics]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_from_new_files_only(tmp_path):
    bench_dir = copy_bench(str(tmp_path))
    before = _digest(bench_dir)
    with open(os.path.join(bench_dir, "configs", "fl-512mb-1card.json")) as f:
        cfg = json.load(f)
    cfg["file_mib"] = 3
    with open(os.path.join(bench_dir, "configs", "fl-3mb-new.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "traffic", "zeros-new.json"), "w") as f:
        json.dump({"placement": "host", "pool": 1, "unit_mib": 1,
                   "parts": [{"kind": "zeros", "mib": 1}]}, f)
    with open(os.path.join(bench_dir, "metrics", "calls_new.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.groups))\n")
    with open(tmp_path / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({"name": "fl-3mb-new", "source": "x",
                             "file": "flrl_bench/configs/fl-3mb-new.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new-cell", "config": "fl-3mb-new",
                               "traffic": "zeros-new", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "calls_new", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "compress_gbps",
                               "workloads": ["new-cell"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    cell = spec.cell("new-cell", str(tmp_path), bench_dir)
    assert cell.config.file_bytes == 3 << 20
    assert cell.traffic.parts == ({"kind": "zeros", "mib": 1},)
    assert "calls_new" in [m.name for m in cell.metrics]
    assert spec.reader("calls_new", bench_dir)(
        type("R", (), {"groups": [1, 2]})()) == 2.0
    after = _digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before


def test_unknown_names_refused(small_root):
    root, bench_dir = small_root
    with pytest.raises(KeyError):
        spec.cell("no-such-cell", root, bench_dir)
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric", bench_dir)
