"""The one general generator of the benchmark's inputs.

A traffic mix is a JSON file, ``traffic/<name>.json``, of parameters only:

* ``placement``: ``"host"`` (each file is a host ``numpy`` u8 array handed
  to the library API) or ``"device"`` (each file is put on the cards once in
  set-up and the device-resident programs run on it);
* ``pool``: how many distinct files the closed loop cycles through;
* ``unit_mib`` and ``parts``: the layout of one file of ``unit_mib`` MiB,
  part by part; a configuration of another size scales every part by
  ``file_mib / unit_mib`` (the last part takes what rounding leaves);
* ``group_seconds``: a timed group repeats one file's call until it has
  lasted this long (0: one call a group), so that no time read from the
  host clock spans less than about 250 ms where one call is shorter;
* ``trace_seconds`` (optional): in a traced run, how much of the window
  the profiler covers (the whole window when absent).

Part kinds (``L`` is the configuration's frame length):

* ``uniform``: frames of L bytes of width exactly ``width`` (each frame's
  first byte is the width's mask, the rest random under it);
* ``widths``: the same with each frame's width drawn from ``lo..hi``;
* ``zeros``: zero bytes;
* ``random``: uniform random bytes;
* ``runs``: runs of random length ``lo..hi`` over values ``0..vmax-1``,
  neighbouring runs of different values.

These are the streams ``chip_smoke.py`` built with NumPy on the host
(``mixed_main_stream``, ``uniform_stream``, ``random_width_stream``,
``runs_stream``, ``rl_mixed_stream``), rewritten for PyTorch so that the
card makes them from ``--seed`` through one ``torch.Generator``: the same
seed gives the same pool on the same kind of device.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import torch

MIB = 1 << 20
PLACEMENTS = ("host", "device")
KINDS = ("uniform", "widths", "zeros", "random", "runs")


@dataclass(frozen=True)
class Traffic:
    name: str
    placement: str
    pool: int
    unit_mib: int
    parts: tuple
    group_seconds: float
    trace_seconds: float | None

    def part_bytes(self, total: int) -> list[int]:
        """Bytes of each part in a file of ``total`` bytes."""
        unit = self.unit_mib * MIB
        sizes = [p["mib"] * MIB * total // unit for p in self.parts]
        sizes[-1] += total - sum(sizes)
        return sizes


def load(path: str) -> Traffic:
    with open(path) as f:
        spec = json.load(f)
    name = os.path.basename(path)[:-len(".json")]
    placement = spec["placement"]
    if placement not in PLACEMENTS:
        raise ValueError(f"traffic {name}: placement {placement!r} is not "
                         f"one of {PLACEMENTS}")
    parts = tuple(spec["parts"])
    for p in parts:
        if p["kind"] not in KINDS:
            raise ValueError(f"traffic {name}: part kind {p['kind']!r} is "
                             f"not one of {KINDS}")
    if sum(p["mib"] for p in parts) != spec["unit_mib"]:
        raise ValueError(f"traffic {name}: parts do not add up to "
                         f"unit_mib = {spec['unit_mib']}")
    if spec["pool"] < 1:
        raise ValueError(f"traffic {name}: pool must be at least 1")
    return Traffic(name, placement, int(spec["pool"]), int(spec["unit_mib"]),
                   parts, float(spec.get("group_seconds", 0.0)),
                   spec.get("trace_seconds"))


def _randint(g, lo: int, hi: int, size, dtype=torch.int64):
    return torch.randint(lo, hi, size, generator=g, device=g.device,
                         dtype=dtype)


def _frames_of_widths(g, widths: torch.Tensor, n: int, L: int):
    """Frames of L random bytes, frame f of width exactly widths[f]."""
    masks = ((1 << widths.to(torch.int32)) - 1).to(torch.uint8)
    data = _randint(g, 0, 256, (widths.numel(), L), torch.uint8)
    data &= masks[:, None]
    data[:, 0] = masks
    return data.reshape(-1)[:n]


def _runs(g, n: int, lo: int, hi: int, vmax: int) -> torch.Tensor:
    count = (n // lo + 1 if lo == hi
             else 2 * n // (lo + hi) * 11 // 10 + 1024)
    if vmax > 1:
        steps = _randint(g, 1, vmax, (count,))
        values = (torch.cumsum(steps, 0) % vmax).to(torch.uint8)
    else:
        values = torch.zeros(count, dtype=torch.uint8, device=g.device)
    lengths = _randint(g, lo, hi + 1, (count,))
    total = int(lengths.sum())
    if total < n:
        raise ValueError(f"runs {lo}..{hi}: {total} bytes drawn for {n}")
    return torch.repeat_interleave(values, lengths, output_size=total)[:n]


def part(g, spec: dict, n: int, L: int) -> torch.Tensor:
    """``n`` bytes of one part on the generator's device."""
    kind = spec["kind"]
    frames = -(-n // L)
    if kind == "uniform":
        widths = torch.full((frames,), spec["width"], dtype=torch.int64,
                            device=g.device)
        return _frames_of_widths(g, widths, n, L)
    if kind == "widths":
        return _frames_of_widths(
            g, _randint(g, spec["lo"], spec["hi"] + 1, (frames,)), n, L)
    if kind == "zeros":
        return torch.zeros(n, dtype=torch.uint8, device=g.device)
    if kind == "random":
        return _randint(g, 0, 256, (n,), torch.uint8)
    return _runs(g, n, spec["lo"], spec["hi"], spec["vmax"])


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def make_file(g, traffic: Traffic, total: int, L: int) -> torch.Tensor:
    """One file of ``total`` bytes, made part by part into one buffer."""
    out = torch.empty(total, dtype=torch.uint8, device=g.device)
    pos = 0
    for spec, n in zip(traffic.parts, traffic.part_bytes(total)):
        out[pos:pos + n] = part(g, spec, n, L)
        pos += n
    return out


def make_pool(traffic: Traffic, total: int, L: int, seed: int,
              device) -> list[torch.Tensor]:
    """The traffic's pool of distinct files, each ``total`` bytes, on
    ``device``, drawn one after another from one generator seeded by
    ``seed``."""
    g = generator(seed, device)
    return [make_file(g, traffic, total, L) for _ in range(traffic.pool)]
