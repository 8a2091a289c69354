"""The spans that the PyTorch package's walks leave in a CPU
``torch.profiler`` trace, for the walk tests (``test_torch_fl.py``,
``test_torch_rl.py``, ``test_torch_mesh.py``, ``test_torch_timers.py``)."""

import contextlib
import re
from dataclasses import dataclass

import numpy as np
from torch.profiler import ProfilerActivity, profile, record_function

# every span name a walk may use (utils/timers.py's families)
FAMILIES = re.compile(r"^flrl\.(host\.[a-z_]+|[hd]2[hd]\.(pinned|pageable)"
                      r"|kernels|wait|gather\.[a-z0-9_]+)$")


@dataclass(frozen=True)
class Range:
    name: str
    start: int
    end: int
    thread: int


@contextlib.contextmanager
def spans():
    """``with spans() as got: ...`` runs the block inside a range named
    ``outer`` under a CPU profiler; afterwards ``got`` holds that range and
    every ``flrl.*`` range the block left, from every thread."""
    got = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            yield got
    for e in prof.profiler.kineto_results.events():
        if e.name() == "outer" or e.name().startswith("flrl."):
            got.append(Range(e.name(), e.start_ns(),
                             e.start_ns() + e.duration_ns(),
                             e.start_thread_id()))


def check(got) -> set:
    """The names of ``got``'s spans, each of a known family and inside the
    outer range."""
    outer = [r for r in got if r.name == "outer"]
    assert len(outer) == 1
    inner = [r for r in got if r.name != "outer"]
    assert inner and all(FAMILIES.match(r.name) for r in inner), inner
    assert all(outer[0].start <= r.start <= r.end <= outer[0].end
               for r in inner)
    return {r.name for r in inner}


def stream(n: int = 400_000, seed: int = 5) -> np.ndarray:
    """A stream no host closed form takes: runs and bytes of every width."""
    rng = np.random.default_rng(seed)
    runs = rng.integers(0, 16, n // 8, dtype=np.uint8).repeat(4)
    return np.concatenate([runs, rng.integers(0, 256, n // 2,
                                              dtype=np.uint8)])
