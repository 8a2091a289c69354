"""The copy-ceiling probe and the plain copy on the GPU, beside their plain
PyTorch versions.

Counterpart of the ``_cp`` Pallas kernel inside ``bench.py``'s ``main``
(``bench.py:417-429``): every u32 word plus one, wrapping; and of
``copy_pallas`` in ``experiments/exp6_r2_tuning.py:80``, a pure copy.  One
kernel, ``flrl_copy_probe`` in ``csrc/copy_probe.cu``, takes the addend;
its wrappers here are

=============  ==================================================
``add_one``    words → words + 1 (mod 2^32), one read and one write
``copy``       words → a copy of them, one read and one write
=============  ==================================================

The words travel as int32 bit-views: on the CPU ``torch.uint32`` has no
arithmetic, and adding 1 to an int32 wraps in two's complement exactly as
a u32 does, so the bits are the same.

A wrapper given a CPU tensor returns its plain version (``add_one_ref``);
given a CUDA tensor it launches its kernel on the current stream or raises.
Each launch adds one to ``LAUNCHES["copy_probe"]`` (``add_one``) or to
``LAUNCHES["copy_words"]`` (``copy``).  An empty tensor launches nothing.
"""

from __future__ import annotations

import torch

from .fl_dense_cuda import (_check, _launch, _on_cuda, _stream, count_launch,
                            reset_table)

LAUNCHES = {"copy_probe": 0, "copy_words": 0}


def reset_launches() -> None:
    reset_table(LAUNCHES)


def add_one_ref(x: torch.Tensor) -> torch.Tensor:
    """``x`` int32[N] (u32 bit-views) plus one, wrapping."""
    return x + 1


def copy_ref(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` int32[N]."""
    return x.clone()


def _add(x: torch.Tensor, addend: int, name: str) -> torch.Tensor:
    y = torch.empty_like(x)
    if x.numel():
        _launch("flrl_copy_probe", x.data_ptr(), y.data_ptr(), x.numel(),
                addend, x.device.index, _stream(x))
        count_launch(LAUNCHES, name, x.device)
    return y


def add_one(x: torch.Tensor) -> torch.Tensor:
    """``x`` int32[N] plus one, wrapping; see :func:`add_one_ref`.  Any
    length and any offset: a start that is not 16-byte aligned takes the
    kernel's word-at-a-time path."""
    _check(x, "x", torch.int32)
    if not _on_cuda(x):
        return add_one_ref(x)
    return _add(x, 1, "copy_probe")


def copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` int32[N] by the probe's kernel with addend 0; see
    :func:`copy_ref`.  Any length and any offset, as :func:`add_one`."""
    _check(x, "x", torch.int32)
    if not _on_cuda(x):
        return copy_ref(x)
    return _add(x, 0, "copy_words")
