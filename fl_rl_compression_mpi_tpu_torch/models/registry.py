"""Codec registry of the PyTorch package: method name → implementation.

``fl`` runs on a CUDA device (``ops/fl_torch.py``): the dense kernels, or
with ``FLRL_NO_DENSE=1`` the field kernels and the host fold.  ``rl`` runs
the RL kernels (``ops/rl_torch.py``).  ``fl-cpu`` and ``rl-cpu`` are
the JAX package's own host codecs (native C++/OpenMP, NumPy fallback),
imported as they are: they involve no JAX.  The other methods of the JAX
package are not ported yet.
"""

from __future__ import annotations

import torch

from fl_rl_compression_mpi_tpu.container import FLCompressed, RLCompressed
from fl_rl_compression_mpi_tpu.models.registry import CODECS as _JAX_CODECS
from fl_rl_compression_mpi_tpu.models.registry import Codec


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


def _rl(data, device=None, **_):
    from ..ops import rl_torch
    counts, values = rl_torch.encode(data, device=device or default_device())
    return RLCompressed(counts, values, data.size)


def _rl_d(comp, device=None, **_):
    from ..ops import rl_torch
    return rl_torch.decode(comp.counts, comp.values,
                           device=device or default_device())


_FL_CPU = _JAX_CODECS["fl-cpu"]
_RL_CPU = _JAX_CODECS["rl-cpu"]

CODECS: dict[str, Codec] = {c.name: c for c in [
    Codec("fl", "fl", "FL on one CUDA device (hand-written Hopper kernels): "
          "dense route, or with FLRL_NO_DENSE=1 the field route (device "
          "fields, pack-2 speculation, host fold)",
          _fl, _fl_d),
    Codec("fl-cpu", "fl", _FL_CPU.description, _FL_CPU.compress,
          _FL_CPU.decompress),
    Codec("rl", "rl", "RL on one CUDA device (hand-written Hopper kernels)",
          _rl, _rl_d),
    Codec("rl-cpu", "rl", _RL_CPU.description, _RL_CPU.compress,
          _RL_CPU.decompress),
]}


def resolve(name: str) -> Codec:
    return CODECS[name]
