"""Host half of the FL field route: fold and unfold.

Counterpart of ``fl_rl_compression_mpi_tpu/ops/fields.py``, which cannot be
imported here: it imports ``fl_jax`` and so JAX.  The device turns each
frame into fields (``ops/fl_fields_cuda.py``); the host folds a frame's
fields into its payload bytes, the reference container's layout, and
unfolds them back.  Fold and unfold run in the native OpenMP library
(``native.py``, ``csrc/flrlio.cpp``) when it is available, else in the
NumPy fallbacks below; the output is the same either way.

The pack-2 layout (two 16-bit fields a u32, the halves of each tile of
``tile_r`` rows of 128 words) is fixed by ``p2_idx16`` in
``csrc/flrlio.cpp``: ``tile_r % 16 == 0`` and ``128 % wpf == 0``.
"""

from __future__ import annotations

import numpy as np

from ..native import get_native
from . import fl_numpy
from .bitpack import FRAME_LENGTH


def host_fold_kind() -> str:
    """``"native"`` or ``"numpy"``: which implementation fold/unfold run."""
    return "numpy" if get_native() is None else "native"


def unspread_fields(fields: np.ndarray, bits: np.ndarray, n: int,
                    frame_length: int = FRAME_LENGTH) -> np.ndarray:
    """Fields → raw bytes (inverse of the device spread)."""
    wpf = frame_length // 4
    b = np.repeat(bits.astype(np.uint32), wpf)[: fields.size]
    mask = ((np.uint32(1) << b) - np.uint32(1)).astype(np.uint32)
    f = fields.astype(np.uint32)
    out = np.empty((fields.size, 4), np.uint8)
    for k in range(4):
        out[:, k] = ((f >> (k * b)) & mask).astype(np.uint8)
    return out.reshape(-1)[:n]


def spread_fields(data: np.ndarray, bits: np.ndarray,
                  frame_length: int = FRAME_LENGTH) -> np.ndarray:
    """Raw bytes → fields (the device spread, on the host)."""
    n = data.size
    frames = -(-n // frame_length)
    buf = np.zeros(frames * frame_length, np.uint8)
    buf[:n] = data
    e = buf.reshape(-1, 4).astype(np.uint32)
    wpf = frame_length // 4
    b = np.repeat(bits.astype(np.uint32), wpf)
    return (e[:, 0] | (e[:, 1] << b) | (e[:, 2] << (2 * b))
            | (e[:, 3] << (3 * b)))


def fold(fields: np.ndarray, bits: np.ndarray, n: int,
         frame_length: int = FRAME_LENGTH) -> np.ndarray:
    """Fields + widths → the container payload (reference layout)."""
    nat = get_native()
    if nat is not None:
        return nat.fl_fold(fields, bits, n, frame_length)
    data = unspread_fields(fields, bits, n, frame_length)
    got_bits, values = fl_numpy.encode(data, frame_length)
    if not np.array_equal(got_bits, bits[: got_bits.size]):
        raise ValueError("fold: bits inconsistent with field content")
    return values


def unfold(values: np.ndarray, bits: np.ndarray, n: int,
           frame_length: int = FRAME_LENGTH) -> np.ndarray:
    """Container payload + widths → fields u32[frames·wpf]."""
    nat = get_native()
    if nat is not None:
        return nat.fl_unfold(values, bits, n, frame_length)
    data = fl_numpy.decode(n, bits, values, frame_length)
    return spread_fields(data, bits, frame_length)


def unpack_p2(packed: np.ndarray, nw: int, tile_r: int) -> np.ndarray:
    """Pack-2 fields → flat u32[nw] fields."""
    q = tile_r // 2
    p = np.asarray(packed).reshape(-1, q, 128)
    out = np.empty((p.shape[0], tile_r, 128), np.uint32)
    out[:, :q] = p & 0xFFFF
    out[:, q:] = p >> 16
    return out.reshape(-1)[:nw]


def pack_p2(fields: np.ndarray, tile_r: int) -> np.ndarray:
    """Flat fields (a whole number of tiles) → the pack-2 layout."""
    q = tile_r // 2
    f = np.asarray(fields, np.uint32).reshape(-1, tile_r, 128)
    return (f[:, :q] | (f[:, q:] << np.uint32(16))).reshape(-1)


def fold_p2(packed: np.ndarray, bits: np.ndarray, n: int,
            frame_length: int, tile_r: int) -> np.ndarray:
    """Pack-2 fields + widths (each ≤ 4) → the container payload."""
    nat = get_native()
    if nat is not None:
        return nat.fl_fold_p2(packed, bits, n, frame_length, tile_r)
    frames = -(-n // frame_length)
    return fold(unpack_p2(packed, frames * (frame_length // 4), tile_r),
                bits, n, frame_length)


def unfold_p2(values: np.ndarray, bits: np.ndarray, n: int,
              frame_length: int, tile_r: int,
              packed_words: int) -> np.ndarray:
    """Container payload + widths (each ≤ 4) → pack-2 fields
    u32[packed_words], zero past the live frames."""
    nat = get_native()
    if nat is not None:
        return nat.fl_unfold_p2(values, bits, n, frame_length, tile_r,
                                packed_words)
    fields = unfold(values, bits, n, frame_length)
    buf = np.zeros(2 * packed_words, np.uint32)
    buf[: fields.size] = fields
    return pack_p2(buf, tile_r)[:packed_words]


# ---------------------------------------------------------------------------
# End-to-end host APIs: thin aliases of the canonical ones in fl_torch (the
# device's kernels and the host fold), kept for discoverability, as the JAX
# module keeps its aliases of fl_jax.
# ---------------------------------------------------------------------------

def encode(data: np.ndarray, frame_length: int = FRAME_LENGTH, *,
           device=None):
    """:func:`fl_torch.encode` on ``device`` (default: the current CUDA
    device)."""
    from ..models.registry import default_device
    from . import fl_torch          # fl_torch imports this module
    return fl_torch.encode(data, frame_length,
                           device=device or default_device())


def decode(output_size: int, bits: np.ndarray, values: np.ndarray,
           frame_length: int = FRAME_LENGTH, *, device=None) -> np.ndarray:
    """:func:`fl_torch.decode` on ``device`` (default: the current CUDA
    device)."""
    from ..models.registry import default_device
    from . import fl_torch
    return fl_torch.decode(output_size, bits, values, frame_length,
                           device=device or default_device())
