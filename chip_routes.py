#!/usr/bin/env python3
"""The FL dense route against the field route on one CUDA GPU (an H100),
and the kernel build's two ways of calling nvcc.

Run from the repository root:  python3 chip_routes.py [--out FILE]

1. build  — a fresh build of csrc/*.cu as ops/_build.py makes it (one nvcc
            a source, all started together, then a link) against one
            `nvcc -shared` over every source, in the order parallel,
            single, single, parallel; seconds on the host clock.
2. routes — the CLI's `c fl` and `d fl` on the 512 MiB mixed and uniform4
            streams of chip_smoke.py (seed 1234), in one fresh process per
            route and stream, in the order dense, fields, fields, dense.
            Each process reports the `--timers` stage lines of its first
            and a repeat call each way, three repeat walls each way without
            timers, and one traced repeat call each way: the device time of
            the copies (Memcpy/Memset) and of the kernels from
            torch.profiler's device events, and the device's idle share of
            the wall.

Prints the card's name and power limit, one JSON line per process, and a
summary of medians; with ``--out FILE`` also writes every number to FILE
as JSON.  Exits nonzero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ROUTE_ORDER = ("dense", "fields", "fields", "dense")
REPEATS = 3


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# one process: one route on one stream
# ---------------------------------------------------------------------------

def _run_cli(*argv: str) -> float:
    from fl_rl_compression_mpi_tpu_torch import cli
    t0 = time.perf_counter()
    rc = cli.main(list(argv))
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0


def _device_split(prof) -> tuple[float, float]:
    """(copy ms, kernel ms) of the device events alone.  Host events (the
    aten ops and runtime calls) also carry device time, that of the
    device events they launched, so summing every event counts each kernel
    and copy twice or more."""
    copy = kern = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        if "Memcpy" in e.key or "Memset" in e.key:
            copy += ms
        else:
            kern += ms
    return copy, kern


def child(src: str, comp: str, back: str) -> None:
    from torch.profiler import ProfilerActivity, profile
    c_argv = ("c", "fl", src, comp)
    d_argv = ("d", "fl", comp, back)
    for label, argv in (("c first", c_argv), ("c repeat", c_argv),
                        ("d first", d_argv), ("d repeat", d_argv)):
        say(f"## {label}")
        _run_cli(*argv, "--timers")
    walls = {"c": [_run_cli(*c_argv) for _ in range(REPEATS)],
             "d": [_run_cli(*d_argv) for _ in range(REPEATS)]}
    busy = {}
    for op, argv in (("c", c_argv), ("d", d_argv)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = _run_cli(*argv)
        copy, kern = _device_split(prof)
        busy[op] = {"wall_s": wall, "device_copy_ms": copy,
                    "device_kernel_ms": kern,
                    "idle_share": 1 - (copy + kern) / (wall * 1e3)}
    say("## RESULT " + json.dumps({"walls": walls, "busy": busy}))


def _parse_child(stdout: str) -> dict:
    section, stages, res = None, {}, None
    for line in stdout.splitlines():
        if line.startswith("## RESULT "):
            res = json.loads(line[len("## RESULT "):])
        elif line.startswith("## "):
            section = line[3:]
            stages[section] = {}
        elif line.startswith("[TIMER] ") and section:
            m = re.match(r"\[TIMER\] (.*?): ([0-9.]+) ms", line)
            if m:
                key = m.group(1)
                while key in stages[section]:
                    key += "+"
                stages[section][key] = float(m.group(2))
    if res is None:
        raise AssertionError("the route process printed no result")
    return {"stages": stages, **res}


# ---------------------------------------------------------------------------
# the two builds
# ---------------------------------------------------------------------------

def time_builds() -> dict:
    from fl_rl_compression_mpi_tpu_torch.ops import _build
    srcs = [p for p in _build._sources() if p.endswith(".cu")]
    nvcc = _build._nvcc()
    out = {"parallel": [], "single": []}
    saved = _build.BUILD_DIR
    for kind in ("parallel", "single", "single", "parallel"):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            if kind == "parallel":
                _build.BUILD_DIR = tmp
                try:
                    _build.build()
                finally:
                    _build.BUILD_DIR = saved
            else:
                subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I",
                                _build.CSRC_DIR, "-shared", "-o",
                                os.path.join(tmp, "lib.so"), *srcs],
                               check=True, capture_output=True)
            out[kind].append(time.perf_counter() - t0)
    say(f"[build] {len(srcs)} sources: parallel "
        f"{', '.join(f'{t:.2f}' for t in out['parallel'])} s; one nvcc "
        f"{', '.join(f'{t:.2f}' for t in out['single'])} s")
    return out


# ---------------------------------------------------------------------------

def _median(xs) -> float:
    return float(np.median(xs))


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--child":
        child(*sys.argv[2:])
        return 0
    out_path = None
    if sys.argv[1:2] == ["--out"] and len(sys.argv) == 3:
        out_path = sys.argv[2]
    elif len(sys.argv) > 1:
        print("usage: chip_routes.py [--out FILE]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("[FAIL] no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fl_rl_compression_mpi_tpu_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    say(smi)
    results = {"card": smi, "builds": time_builds()}
    _build.lib()
    rng = np.random.default_rng(cs.SEED)
    streams = {"mixed": cs.mixed_main_stream(rng),
               "uniform4": cs.uniform_stream(rng, 512 * cs.MIB, 128, 4)}
    runs = results["runs"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in streams.items():
            src = os.path.join(tmp, name + ".bin")
            data.tofile(src)
            for route in ROUTE_ORDER:
                env = dict(os.environ)
                env.pop("FLRL_NO_DENSE", None)
                if route == "fields":
                    env["FLRL_NO_DENSE"] = "1"
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--child",
                     src, os.path.join(tmp, "o.fl"),
                     os.path.join(tmp, "o.bin")],
                    cwd=REPO, env=env, capture_output=True, text=True)
                if proc.returncode:
                    raise AssertionError(f"{name} {route} failed:\n"
                                         f"{proc.stderr[-3000:]}")
                res = _parse_child(proc.stdout)
                runs.setdefault(f"{name}/{route}", []).append(res)
                say(f"{name} {route}: {json.dumps(res)}")
    say("[summary] median repeat walls (s) and idle shares, "
        "c / d, per stream and route:")
    for key, rs in runs.items():
        c = _median([w for r in rs for w in r["walls"]["c"]])
        d = _median([w for r in rs for w in r["walls"]["d"]])
        idle = {op: [round(r["busy"][op]["idle_share"], 3) for r in rs]
                for op in ("c", "d")}
        kern = {op: [round(r["busy"][op]["device_kernel_ms"], 2) for r in rs]
                for op in ("c", "d")}
        say(f"[summary] {key}: c {c:.3f} s, d {d:.3f} s; idle c {idle['c']}, "
            f"d {idle['d']}; profiler kernel ms c {kern['c']}, d {kern['d']}")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
