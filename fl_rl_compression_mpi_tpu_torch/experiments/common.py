"""What the experiment entry points share: their command line, chain
timing and the device record printed beside every result."""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..bench import Clock, device_info, resolve_device


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card) or cpu (the plain "
                        "versions)")
    p.add_argument("--smoke", action="store_true",
                   help="a small size, one cycle and short chains, each "
                        "timed once (the JAX script's SMOKE setting)")
    return p


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
