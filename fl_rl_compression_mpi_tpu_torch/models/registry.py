"""Codec registry of the PyTorch package: method name → implementation.

``fl`` runs on a CUDA device (``ops/fl_torch.py``): the dense kernels, or
with ``FLRL_NO_DENSE=1`` the field kernels and the host fold.  ``rl`` runs
the RL kernels (``ops/rl_torch.py``).  ``fl-dist``, ``fl-ici`` and
``rl-dist`` run the same chains on every shard of a mesh of devices that
this one process drives, a host thread a card, or on the ranks of a
caller's ``torch.distributed`` group (``parallel/dist.py``).  ``fl-cpu`` and
``rl-cpu`` are the host codecs: this package's copy of the native
C++/OpenMP library, with the NumPy goldens as fallback.  ``fl-mpi`` and
``fl-nccl`` are aliases of ``fl-dist`` and ``fl-ici``, as in the JAX
package's registry, whose table this one mirrors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..container import FLCompressed, RLCompressed
from ..native import get_native


@dataclasses.dataclass(frozen=True)
class Codec:
    name: str
    family: str                       # "fl" | "rl"
    description: str
    compress: Callable[..., object]   # (data, **opts) -> container struct
    decompress: Callable[..., np.ndarray]  # (container, **opts) -> bytes
    distributed: bool = False


def default_device() -> torch.device:
    """The device ``fl`` and ``rl`` run on when none is given: the current
    CUDA device.  There is no CPU run of either unless a caller asks for
    one."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _fl(data, frame_length=128, device=None, **_):
    from ..ops import fl_torch
    bits, values = fl_torch.encode(data, frame_length,
                                   device=device or default_device())
    return FLCompressed(bits, values, data.size)


def _fl_d(comp, frame_length=128, device=None, **_):
    from ..ops import fl_torch
    return fl_torch.decode(comp.input_size, comp.bits, comp.values,
                           frame_length, device=device or default_device())


def _fl_cpu(data, frame_length=128, **_):
    nat = get_native()
    if nat is not None:
        bits, values = nat.fl_encode(data, frame_length)
    else:
        from ..ops import fl_numpy
        bits, values = fl_numpy.encode(data, frame_length)
    return FLCompressed(bits, values, data.size)


def _fl_cpu_d(comp, frame_length=128, **_):
    nat = get_native()
    if nat is not None:
        return nat.fl_decode(comp.input_size, comp.bits, comp.values,
                             frame_length)
    from ..ops import fl_numpy
    return fl_numpy.decode(comp.input_size, comp.bits, comp.values,
                           frame_length)


def _rl(data, device=None, **_):
    from ..ops import rl_torch
    counts, values = rl_torch.encode(data, device=device or default_device())
    return RLCompressed(counts, values, data.size)


def _rl_d(comp, device=None, **_):
    from ..ops import rl_torch
    return rl_torch.decode(comp.counts, comp.values,
                           device=device or default_device())


def _rl_cpu(data, **_):
    nat = get_native()
    if nat is not None:
        counts, values = nat.rl_encode(data)
    else:
        from ..ops import rl_numpy
        counts, values = rl_numpy.encode(data)
    return RLCompressed(counts, values, data.size)


def _rl_cpu_d(comp, **_):
    nat = get_native()
    if nat is not None:
        return nat.rl_decode(comp.counts, comp.values)
    from ..ops import rl_numpy
    return rl_numpy.decode(comp.counts, comp.values)


def _shard_device(device):
    """The device every shard takes, or None for one CUDA device a shard
    (``cuda:i``), the default wherever :func:`default_device` is a CUDA
    device."""
    if device is not None:
        return torch.device(device)
    d = default_device()
    return None if d.type == "cuda" else d


def _distributed(name: str):
    """A registry entry point that runs ``parallel.dist.<name>`` on a mesh
    of ``devices`` shards in this process, or on a caller's process group
    (see ``dist.run_collective``); RL takes no frame length."""
    def run(x, frame_length=128, devices=None, device=None, **_):
        from ..parallel import dist
        args = (x,) if name.endswith("_rl") else (x, frame_length)
        return dist.run_collective(getattr(dist, name), *args,
                                   devices=devices,
                                   device=_shard_device(device))
    return run


CODECS: dict[str, Codec] = {c.name: c for c in [
    Codec("fl", "fl", "FL on one CUDA device (hand-written Hopper kernels): "
          "dense route, or with FLRL_NO_DENSE=1 the field route (device "
          "fields, pack-2 speculation, host fold)",
          _fl, _fl_d),
    Codec("fl-cpu", "fl", "FL on host (native C++/OpenMP, NumPy fallback)",
          _fl_cpu, _fl_cpu_d),
    Codec("fl-dist", "fl", "FL over N CUDA devices driven from one "
          "process, a shard a card, merged in shard order on the host "
          "(reference fl-mpi analog)",
          _distributed("compress_fl"),
          _distributed("decompress_fl"), distributed=True),
    Codec("fl-ici", "fl", "FL over N CUDA devices driven from one "
          "process, the payloads gathered card to card onto the first card "
          "and copied down once (reference fl-nccl analog)",
          _distributed("compress_fl_ici"),
          _distributed("decompress_fl"), distributed=True),
    Codec("rl", "rl", "RL on one CUDA device (hand-written Hopper kernels)",
          _rl, _rl_d),
    Codec("rl-cpu", "rl", "RL on host (native C++/OpenMP, NumPy fallback)",
          _rl_cpu, _rl_cpu_d),
    Codec("rl-dist", "rl", "RL over N CUDA devices driven from one "
          "process, a shard a card (per-shard runs)",
          _distributed("compress_rl"),
          _distributed("decompress_rl"), distributed=True),
]}

ALIASES = {"fl-mpi": "fl-dist", "fl-nccl": "fl-ici"}


def resolve(name: str) -> Codec:
    return CODECS[ALIASES.get(name, name)]
