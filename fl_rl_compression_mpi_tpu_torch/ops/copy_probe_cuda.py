"""The copy-ceiling probe on the GPU, beside its plain PyTorch version.

Counterpart of the ``_cp`` Pallas kernel inside ``bench.py``'s ``main``
(``bench.py:417-429``): every u32 word plus one, wrapping.  The kernel lives
in ``csrc/copy_probe.cu``; its wrapper here is

=============  ==================================================
``add_one``    words → words + 1 (mod 2^32), one read and one write
=============  ==================================================

The words travel as int32 bit-views: on the CPU ``torch.uint32`` has no
arithmetic, and adding 1 to an int32 wraps in two's complement exactly as
a u32 does, so the bits are the same.

A wrapper given a CPU tensor returns its plain version (``add_one_ref``);
given a CUDA tensor it launches its kernel on the current stream or raises.
Each launch adds one to ``LAUNCHES["copy_probe"]``.  An empty tensor
launches nothing.
"""

from __future__ import annotations

import torch

from .fl_dense_cuda import _check, _launch, _on_cuda, _stream

LAUNCHES = {"copy_probe": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def add_one_ref(x: torch.Tensor) -> torch.Tensor:
    """``x`` int32[N] (u32 bit-views) plus one, wrapping."""
    return x + 1


def add_one(x: torch.Tensor) -> torch.Tensor:
    """``x`` int32[N] plus one, wrapping; see :func:`add_one_ref`.  Any
    length and any offset: a start that is not 16-byte aligned takes the
    kernel's word-at-a-time path."""
    _check(x, "x", torch.int32)
    if not _on_cuda(x):
        return add_one_ref(x)
    y = torch.empty_like(x)
    if x.numel():
        _launch("flrl_copy_probe", x.data_ptr(), y.data_ptr(), x.numel(),
                x.device.index, _stream(x))
        LAUNCHES["copy_probe"] += 1
    return y
