"""Constant-stream FL kernels on the GPU, each beside its plain PyTorch
version.

Counterpart of the constant section of
``fl_rl_compression_mpi_tpu/ops/fl_dense_pallas.py``
(``fl_encode_dense_constant_pallas``, ``fl_decode_dense_constant_pallas``,
``host_probe_constant``).  The kernels live in ``csrc/fl_constant.cu``; their
wrappers here are

===================  ====================================================
``encode_constant``  verify every byte == c; emit widths fb and the payload
``decode_constant``  verify the payload against the pattern; broadcast c
===================  ====================================================

A stream of one constant byte c packs, at 128-byte frames, to widths all
``fb = max(1, c.bit_length())`` and, where fb divides 8, a payload whose
every byte is :func:`pattern_byte` (c's fb bits repeated).  Both kernels
are speculative, as on the TPU: a caller picks c with
:func:`host_probe_constant`, and the returned flag (int32[1], nonzero on a
mismatch) is authoritative; on a flag the outputs are junk and the caller
re-runs the uniform or general kernels.  Validity is the JAX package's:
fb in {1, 2, 4, 8}, and c == 0 or n % 128 == 0.

A wrapper given CPU tensors returns its plain version (``*_ref``); given
CUDA tensors it launches its kernel on the current stream or raises.  Each
launch adds one to ``LAUNCHES[<kernel>]``.  An empty stream launches
nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from .fl_dense_cuda import (DENSE_UNIFORM_TILE_R, _check, _launch, _on_cuda,
                            _stream, count_launch, reset_table)

FRAME = 128
FAST_BS = (1, 2, 4, 8)

LAUNCHES = {"fl_const_encode": 0, "fl_const_decode": 0}


def reset_launches() -> None:
    reset_table(LAUNCHES)


def check_constant(cbyte: int, fb: int, n: int) -> None:
    """The JAX kernels' validity rule (``fl_dense_pallas.py:1729``)."""
    if not 0 <= cbyte <= 255 or fb not in FAST_BS \
            or fb != max(1, int(cbyte).bit_length()):
        raise ValueError(f"constant kernels need fb = max(1, bitlen(c)) in "
                         f"{FAST_BS}, got c={cbyte}, fb={fb}")
    if cbyte != 0 and n % FRAME:
        raise ValueError(f"a nonzero constant needs n % {FRAME} == 0, got "
                         f"c={cbyte}, n={n}")


def pattern_byte(cbyte: int, fb: int) -> int:
    """Every payload byte of a constant-``cbyte`` stream at width fb (fb
    divides 8): c's low fb bits repeated 8/fb times, the byte of
    ``fl_dense_pallas.const_payload_word``."""
    p = 0
    for i in range(0, 8, fb):
        p |= (cbyte & ((1 << fb) - 1)) << i
    return p


def payload_size(n: int, fb: int) -> int:
    """Payload bytes of an n-byte constant stream at width fb."""
    return -(-n * fb // 8)


def host_probe_constant(data: np.ndarray, n: int,
                        tile_r: int | None = None):
    """Host probe for the constant kernels: ``(cbyte, fb)`` when the first
    ``tile_r``·512 bytes are one constant byte whose width is in FAST_BS and
    the validity rule holds (c == 0, or no partial tail frame), else None.
    The kernels' flag stays authoritative for the rest of the stream."""
    R = DENSE_UNIFORM_TILE_R if tile_r is None else tile_r
    if data.size < R * 512 or n <= 0:
        return None
    head = np.asarray(data[: R * 512], np.uint8)
    c = int(head[0])
    if not bool((head == c).all()):
        return None
    fb = max(1, c.bit_length())
    if fb not in FAST_BS or not (c == 0 or n % FRAME == 0):
        return None
    return c, fb


# ---------------------------------------------------------------------------
# Plain PyTorch versions.
# ---------------------------------------------------------------------------

def encode_constant_ref(data: torch.Tensor, cbyte: int, fb: int):
    """``(bits u8[F], values u8[V], flag i32[1])`` of ``data`` u8[n]
    speculated constant ``cbyte``: F = ceil(n/128) widths of fb, V =
    ceil(n·fb/8) pattern bytes, flag 1 when some byte differs."""
    n = data.numel()
    dev = data.device
    bits = torch.full((-(-n // FRAME),), fb, dtype=torch.uint8, device=dev)
    values = torch.full((payload_size(n, fb),), pattern_byte(cbyte, fb),
                        dtype=torch.uint8, device=dev)
    flag = (data != cbyte).any().to(torch.int32).reshape(1)
    return bits, values, flag


def decode_constant_ref(values: torch.Tensor, values_size: int, cbyte: int,
                        fb: int, n: int):
    """``(out u8[n], flag i32[1])``: n bytes of ``cbyte``; flag 1 when one
    of the first ``values_size`` bytes of ``values`` is not the pattern
    byte (bytes past values_size are not read)."""
    out = torch.full((n,), cbyte, dtype=torch.uint8, device=values.device)
    flag = (values[:values_size] != pattern_byte(cbyte, fb)).any()
    return out, flag.to(torch.int32).reshape(1)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def encode_constant(data: torch.Tensor, cbyte: int, fb: int):
    """``(bits, values, flag)`` of ``data`` u8[n]; see
    :func:`encode_constant_ref`."""
    _check(data, "data", torch.uint8)
    n = data.numel()
    check_constant(cbyte, fb, n)
    if not _on_cuda(data):
        return encode_constant_ref(data, cbyte, fb)
    dev = data.device
    bits = torch.empty(-(-n // FRAME), dtype=torch.uint8, device=dev)
    values = torch.empty(payload_size(n, fb), dtype=torch.uint8, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    if n:
        _launch("flrl_const_encode", data.data_ptr(), n, cbyte, fb,
                bits.data_ptr(), values.data_ptr(), flag.data_ptr(),
                dev.index, _stream(data))
        count_launch(LAUNCHES, "fl_const_encode", dev)
    return bits, values, flag


def decode_constant(values: torch.Tensor, values_size: int, cbyte: int,
                    fb: int, n: int):
    """``(out, flag)`` of the payload ``values`` (at least ``values_size``
    bytes); see :func:`decode_constant_ref`."""
    _check(values, "values", torch.uint8)
    check_constant(cbyte, fb, n)
    if not 0 <= values_size <= values.numel():
        raise ValueError(f"values_size {values_size} outside the "
                         f"{values.numel()}-byte payload buffer")
    if not _on_cuda(values):
        return decode_constant_ref(values, values_size, cbyte, fb, n)
    dev = values.device
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    if n or values_size:
        _launch("flrl_const_decode", values.data_ptr(), values_size, cbyte,
                fb, out.data_ptr(), n, flag.data_ptr(), dev.index,
                _stream(values))
        count_launch(LAUNCHES, "fl_const_decode", dev)
    return out, flag
