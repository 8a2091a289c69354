"""One run of one cell: set-up, the measured window, the check, the line.

    python -m flrl_bench --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The traffic is a closed loop with one client: it takes the pool's files in
turn, compresses one, decompresses the container it got, and only then
takes the next.  Each group of calls is timed on the host clock, from its
first call's start to its last call's result on the host (or, where the
results stay on the cards, to a synchronise of every card).  Set-up makes
the pool from ``--seed`` on the card, loads it, and warms exactly the
cell's shapes with one round trip of every pool file; ``setup_s`` runs
from the process's start to the window's first call.

After the window: the device's memory peak is read, the program's state
freed, and the plain reference (``reference.py``) judges a sample of the
window's answers drawn from the seed (``check.py``).  The last line of
standard output is one JSON object; the numbers compared, each with its
limit, close standard error and the line.  A run on a machine with fewer
cards than the cell asks for exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field

from . import check, spec
from .trace import breakdown, busy_seconds, digest

# modules that must not be loaded in a run, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "fl_rl_compression_mpi_tpu")
# the card's published peak (NVIDIA H100 SXM data sheet): HBM3 bytes/s
PEAK_BYTES_PER_S = 3.35e12
CACHE_DIR = os.path.join(spec.ROOT, ".bench_cache")


@dataclass
class Group:
    """One timed group: ``calls`` calls of one direction on one file."""
    kind: str             # "c" | "d"
    file: int
    calls: int
    bytes_in: int         # every call's input bytes, summed
    bytes_out: int        # every call's output bytes, summed
    wall_s: float
    traced: bool = False
    turn: int = 0


@dataclass
class Run:
    """What the metric readers read."""
    cell: spec.Cell
    setup_s: float
    groups: list = field(default_factory=list)
    trace: object = None  # trace.Trace in a traced run
    peak_bytes_per_s: float = PEAK_BYTES_PER_S


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _cache_env() -> None:
    """Build and kernel caches of everything the run loads live at fixed
    paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ.setdefault(var, os.path.join(CACHE_DIR, sub))


def _timed(driver, fn, arg, group_s: float):
    """``fn(arg)`` once, then again until the group has lasted
    ``group_s``; returns (last result, calls, seconds)."""
    calls = 0
    t0 = time.perf_counter()
    while True:
        out = fn(arg)
        driver.sync()
        calls += 1
        wall = time.perf_counter() - t0
        if wall >= group_s:
            return out, calls, wall


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             t_start: float, device=None, log=print,
             bench_dir: str = spec.HERE) -> dict:
    """The run; returns the result line's fields, ``checks`` last.
    ``device`` None runs on the cards; the tests pass the CPU."""
    import torch
    from . import drivers, traffic
    for key, value in cell.config.env.items():
        os.environ[key] = str(value)
    cfg, mix = cell.config, cell.traffic
    driver = drivers.make(cfg, mix, device)
    home = torch.device("cuda", 0) if device is None else torch.device(device)
    t_pool = time.perf_counter()
    pool = traffic.make_pool(mix, cfg.file_bytes, cfg.frame_length, seed,
                             home)
    driver.load(pool)
    del pool
    t_warm = time.perf_counter()
    cards = driver.cards
    if device is None:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
    sizes, out_bytes = {}, {}
    for k in range(mix.pool):
        comp = driver.compress(k)
        out = driver.decompress(comp)
        driver.sync()
        sizes[k] = driver.sizes(comp, out)
        out_bytes[k] = driver.container_bytes(comp)
        driver.keep(comp, out, k)
        del comp, out
    run = Run(cell, time.perf_counter() - t_start)
    log(f"[flrl_bench] setup: {t_pool - t_start:.3f} s to the pool (start, "
        f"imports, cards), {t_warm - t_pool:.3f} s the pool made and loaded, "
        f"{t_start + run.setup_s - t_warm:.3f} s the warm round trips",
        file=sys.stderr)

    sampler = check.Sampler(seed, mix.pool)
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    trace_until = (seconds if mix.trace_seconds is None
                   else min(seconds, float(mix.trace_seconds)))

    def span(name):
        """The harness's span around a timed group, in a traced run."""
        return (contextlib.nullcontext() if prof is None
                else record_function(name))

    attempted = failed = sizes_wrong = 0
    turn = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        k = turn % mix.pool
        on = prof is not None
        n, cb = cfg.file_bytes, out_bytes[k]
        try:
            with span("flrl_bench.c"):
                comp, calls, wall = _timed(driver, driver.compress, k,
                                           mix.group_seconds)
            attempted += calls
            run.groups.append(Group("c", k, calls, n * calls, cb * calls,
                                    wall, on, turn))
            with span("flrl_bench.d"):
                out, calls, wall = _timed(driver, driver.decompress, comp,
                                          mix.group_seconds)
            attempted += calls
            run.groups.append(Group("d", k, calls, cb * calls, n * calls,
                                    wall, on, turn))
        except Exception as e:  # a failed call counts, and the loop goes on
            attempted += 1
            failed += 1
            log(f"[flrl_bench] turn {turn}: {type(e).__name__}: {e}",
                file=sys.stderr)
            comp = out = None
        else:
            if driver.sizes(comp, out) != sizes[k]:
                sizes_wrong += 1
            sampler.offer(turn, k, lambda: driver.keep(comp, out, k))
        del comp, out
        turn += 1
        if prof is not None and time.perf_counter() - t0 >= trace_until:
            run.trace = _stop(prof, cards, log)
            prof = None
    if prof is not None:
        run.trace = _stop(prof, cards, log)
    window_s = time.perf_counter() - t0

    peak = (max(torch.cuda.max_memory_allocated(c) for c in cards)
            if cards else 0)
    driver.close()
    if device is None:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = check.judge(cfg, mix, driver, sampler, home, seed,
                          failed=failed, sizes_wrong=sizes_wrong)
    log(f"[flrl_bench] reference check of {len(sampler.kept)} answers: "
        f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    metrics = {}
    kind = "per_layer" if traced else "end_to_end"
    for m in cell.metrics:
        if m.kind != kind:
            continue
        value = spec.reader(m.name, bench_dir)(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if device is None else str(device),
           "kind": (torch.cuda.get_device_name(cards[0]) if cards
                    else str(device)),
           "count": cfg.cards, "memory_peak_bytes": int(peak)}
    result = {"correct": check.correct(numbers), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = busy_seconds(run.trace) if cards else 0.0
        dev["window_s"] = run.trace.window_ns / 1e9
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in numbers.items()}
    log(f"[flrl_bench] {cell.workload}: {turn} turns, {attempted} calls in "
        f"{window_s:.3f} s, setup {run.setup_s:.3f} s", file=sys.stderr)
    return result


def _stop(prof, cards, log):
    t = time.perf_counter()
    prof.stop()
    trace = digest(prof, cards)
    log(f"[flrl_bench] trace: {len(trace.ops)} device ops, {len(trace.host)} "
        f"host ops, {len(trace.spans)} spans; stop and digest "
        f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    return trace


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, t_start: float | None = None, *, root: str = spec.ROOT,
         bench_dir: str = spec.HERE, device=None) -> int:
    """The command.  ``device`` None looks for the cards and runs there;
    the tests pass the CPU, which skips that look."""
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(prog="python -m flrl_bench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_env()
    cell = spec.cell(args.workload, root, bench_dir)
    import torch
    if device is not None:
        pass
    elif not torch.cuda.is_available():
        print("[flrl_bench] no CUDA device: this benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    elif torch.cuda.device_count() < cell.chips:
        print(f"[flrl_bench] {cell.workload} needs {cell.chips} cards, this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start, device, bench_dir=bench_dir)
    found = loaded_forbidden()
    if found:
        print(f"[flrl_bench] loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"[flrl_bench] card: {_power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
