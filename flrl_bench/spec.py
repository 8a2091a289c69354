"""Finding the benchmark's pieces by name.

``BENCHMARK.json`` at the root of the checkout names the cells; a cell
names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); every metric, end-to-end and per-layer, has a
reader of its own (``metrics/<name>.py``, a function ``read(run)`` that
returns a number, or None where it finds nothing to read).  Adding a
cell, a mix or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

from . import traffic as traffic_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CODECS = ("fl", "rl")


@dataclass(frozen=True)
class Config:
    """One deployment of the codec: what the configuration file states."""
    name: str
    codec: str            # "fl" | "rl": the container format
    method: str           # the library API's method name
    frame_length: int
    file_mib: int
    cards: int
    shards: int           # shards the container is cut into (RL runs split)
    env: dict = field(default_factory=dict)

    @property
    def file_bytes(self) -> int:
        return self.file_mib * traffic_mod.MIB


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    kind: str             # "end_to_end" | "per_layer"
    workloads: tuple | None

    def applies(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads


@dataclass(frozen=True)
class Cell:
    workload: str
    chips: int
    config: Config
    traffic: traffic_mod.Traffic
    metrics: tuple        # of Metric, in BENCHMARK.json's order


def load_config(path: str) -> Config:
    with open(path) as f:
        spec = json.load(f)
    name = os.path.basename(path)[:-len(".json")]
    if spec["codec"] not in CODECS:
        raise ValueError(f"config {name}: codec {spec['codec']!r} is not "
                         f"one of {CODECS}")
    return Config(name, spec["codec"], spec["method"],
                  int(spec["frame_length"]), int(spec["file_mib"]),
                  int(spec["cards"]), int(spec.get("shards", 1)),
                  dict(spec.get("env", {})))


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _metrics(bench: dict, workload: str) -> tuple:
    out = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            wl = m.get("workloads")
            metric = Metric(m["name"], m["unit"], kind,
                            None if wl is None else tuple(wl))
            if metric.applies(workload):
                out.append(metric)
    return tuple(out)


def cell(workload: str, root: str = ROOT, bench_dir: str = HERE) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json, its files read
    from ``bench_dir``."""
    bench = benchmark(root)
    for w in bench["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = None
    for c in bench["configs"]:
        if c["name"] == w["config"]:
            config = load_config(os.path.join(root, c["file"]))
    if config is None:
        raise KeyError(f"workload {workload}: no config {w['config']!r}")
    mix = traffic_mod.load(os.path.join(bench_dir, "traffic",
                                        w["traffic"] + ".json"))
    return Cell(workload, int(w["chips"]), config, mix,
                _metrics(bench, workload))


def reader(name: str, bench_dir: str = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "flrl_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
