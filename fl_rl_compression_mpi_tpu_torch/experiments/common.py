"""What the experiment entry points share: their command line, chain
timing and the device record printed beside every result."""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..models import registry


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card) or cpu (the plain "
                        "versions)")
    p.add_argument("--smoke", action="store_true",
                   help="a small size, one cycle and short chains, each "
                        "timed once (the JAX script's SMOKE setting)")
    return p


def device_info(dev: torch.device) -> dict:
    """The card's name and its power limit as nvidia-smi reads it."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    try:
        limit = subprocess.run(
            ["nvidia-smi", f"--id={dev.index}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"device": torch.cuda.get_device_name(dev), "power_limit": limit}


def resolve_device(name: str) -> torch.device:
    """``cpu`` runs the plain versions; anything else must be a card."""
    if name == "cpu":
        return torch.device("cpu")
    if name == "cuda":
        return registry.default_device()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    return torch.device(name)


class Clock:
    """Seconds of device work: CUDA events on a card, the host clock on
    the CPU (where the plain versions run synchronously)."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def seconds(self, fn) -> float:
        if not self.cuda:
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


def setup(args) -> tuple:
    """``(device, clock)`` of the parsed arguments; prints the device
    record (name and power limit) first."""
    dev = resolve_device(args.device)
    print(json.dumps(device_info(dev)), flush=True)
    return dev, Clock(dev)


def time_chain(clock: Clock, chain, x, inner: int, reps: int = 3) -> float:
    """Seconds a step of ``chain(x, k)``: k = 1 + inner steps less k = 1,
    over inner, median of ``reps``, after one run of each (the JAX
    scripts' ``time_chain``, with device time from CUDA events)."""
    chain(x, 1)
    chain(x, 1 + inner)
    clock.sync()
    ts = []
    for _ in range(reps):
        t1 = clock.seconds(lambda: chain(x, 1))
        t2 = clock.seconds(lambda: chain(x, 1 + inner))
        ts.append((t2 - t1) / inner)
    return max(float(np.median(ts)), 1e-9)


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
