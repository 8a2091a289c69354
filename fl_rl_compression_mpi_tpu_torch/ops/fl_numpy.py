"""NumPy golden implementation of the FL (fixed-length) codec.

Semantics are a from-scratch re-derivation of the reference CPU codec
(``reference/src/fl/fl_cpu.cu:9-90`` compress, ``:92-147`` decompress):

* the input byte stream is cut into frames of ``frame_length`` bytes;
* each frame's bit-width is ``max(1, 8 - clz(byte))`` over its bytes;
* each byte is re-packed into ``bits[frame]`` bits, LSB-first within bytes,
  frames back-to-back (full frames are byte-aligned for frame lengths that
  are multiples of 8);
* output is ``(bits: u8[ceil(N/L)], values: u8[ceil(total_bits/8)])``.

Two variants live here:

* ``encode_seq`` / ``decode_seq`` — literal sequential transcriptions of the
  algorithm, used as the paranoid oracle on tiny inputs;
* ``encode`` / ``decode`` — vectorized NumPy using the shared static pack
  tables (`bitpack.py`), fast enough to oracle multi-MB inputs and structured
  identically to the JAX/Pallas device paths.
"""

from __future__ import annotations

import numpy as np

from .bitpack import (
    FRAME_LENGTH,
    MAX_WIDTH,
    pack_tables,
    required_bits_u8,
    unpack_tables,
)


# ---------------------------------------------------------------------------
# Sequential oracle (tiny inputs only).
# ---------------------------------------------------------------------------

def encode_seq(data: np.ndarray, frame_length: int = FRAME_LENGTH):
    data = np.asarray(data, np.uint8)
    n = data.size
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
    frames = (n + frame_length - 1) // frame_length
    bits = np.zeros(frames, np.uint8)
    total_bits = 0
    for f in range(frames):
        chunk = data[f * frame_length : min((f + 1) * frame_length, n)]
        b = 1
        for v in chunk:
            b = max(b, int(v).bit_length())
        bits[f] = b
        total_bits += b * chunk.size
    values = np.zeros((total_bits + 7) // 8, np.uint8)
    used = 0
    for f in range(frames):
        b = int(bits[f])
        chunk = data[f * frame_length : min((f + 1) * frame_length, n)]
        for v in chunk:
            v = int(v)
            byte, off = used // 8, used % 8
            values[byte] |= (v << off) & 0xFF
            if off + b > 8:
                values[byte + 1] |= v >> (8 - off)
            used += b
    return bits, values


def decode_seq(output_size: int, bits: np.ndarray, values: np.ndarray,
               frame_length: int = FRAME_LENGTH) -> np.ndarray:
    bits = np.asarray(bits, np.uint8)
    values = np.asarray(values, np.uint8)
    if bits.size == 0 or values.size == 0:
        return np.zeros(0, np.uint8)
    out = np.zeros(output_size, np.uint8)
    used = 0
    for f in range(bits.size):
        b = int(bits[f])
        mask = (1 << b) - 1
        for i in range(frame_length):
            o = f * frame_length + i
            if o >= output_size:
                break
            byte, off = used // 8, used % 8
            v = (int(values[byte]) >> off) & mask
            if off + b > 8:
                ob = off + b - 8
                v |= (int(values[byte + 1]) & ((1 << ob) - 1)) << (b - ob)
            out[o] = v
            used += b
    return out


# ---------------------------------------------------------------------------
# Vectorized golden (mirrors the device formulation).
# ---------------------------------------------------------------------------

def frame_geometry(n: int, frame_length: int = FRAME_LENGTH):
    """Per-frame element counts for an ``n``-byte input (int64 — no 2 GB bug:
    the reference's ``int`` chunk math at ``file_io.cu:46-51`` is documented
    as a defect, not replicated)."""
    frames = (n + frame_length - 1) // frame_length
    counts = np.full(frames, frame_length, np.int64)
    if frames:
        counts[-1] = n - frame_length * (frames - 1)
    return frames, counts


def frame_bits(data_padded: np.ndarray, frame_length: int = FRAME_LENGTH):
    """Per-frame minimal bit-widths from zero-padded ``(F, L)`` frames.

    bitlen is monotone, so ``max(bitlen(x)) == bitlen(max(x))`` — one
    max-reduce per frame replaces the reference's shared-memory atomicMax
    tree (``fl_gpu.cu:648-685``).  Zero padding never raises the max and the
    width floor is 1, so tail-frame padding is harmless.
    """
    frames = data_padded.reshape(-1, frame_length)
    return required_bits_u8(frames.max(axis=1))


def encode(data: np.ndarray, frame_length: int = FRAME_LENGTH):
    """Vectorized FL encode.  Returns ``(bits u8[F], values u8[V])``."""
    data = np.asarray(data, np.uint8)
    n = data.size
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
    nframes, counts = frame_geometry(n, frame_length)
    padded = np.zeros(nframes * frame_length, np.uint8)
    padded[:n] = data
    frames = padded.reshape(nframes, frame_length).astype(np.int32)
    bits = frame_bits(padded, frame_length)

    nb = (counts * bits + 7) // 8  # bytes per frame (tail may be partial)
    offs = np.zeros(nframes + 1, np.int64)
    np.cumsum(nb, out=offs[1:])
    values = np.zeros(offs[-1], np.uint8)

    tables = pack_tables(frame_length)
    for b in range(1, MAX_WIDTH + 1):
        sel = np.nonzero(bits == b)[0]
        if sel.size == 0:
            continue
        idx, ls, rs, valid, nbytes = tables[b]
        g = frames[sel][:, idx]                      # (Fb, nbytes, T)
        v = np.where(valid, (g << ls) >> rs, 0)
        packed = np.bitwise_or.reduce(v, axis=2).astype(np.uint8)
        tgt = offs[sel][:, None] + np.arange(nbytes, dtype=np.int64)
        mask = np.arange(nbytes) < nb[sel][:, None]
        values[tgt[mask]] = packed[mask]
    return bits.astype(np.uint8), values


def decode(output_size: int, bits: np.ndarray, values: np.ndarray,
           frame_length: int = FRAME_LENGTH) -> np.ndarray:
    """Vectorized FL decode (inverse of :func:`encode`)."""
    bits = np.asarray(bits, np.uint8).astype(np.int32)
    values = np.asarray(values, np.uint8)
    if bits.size == 0 or values.size == 0:
        return np.zeros(0, np.uint8)
    nframes = bits.size
    _, counts = frame_geometry(output_size, frame_length)
    if counts.size != nframes:
        raise ValueError(
            f"bits array has {nframes} frames but output_size={output_size} "
            f"implies {counts.size}")
    nb = (counts * bits + 7) // 8
    offs = np.zeros(nframes + 1, np.int64)
    np.cumsum(nb, out=offs[1:])

    row_len = (frame_length * MAX_WIDTH) // 8 + 1
    vpad = np.zeros(values.size + row_len, np.uint8)
    vpad[: values.size] = values

    out = np.zeros((nframes, frame_length), np.uint8)
    tables = unpack_tables(frame_length)
    for b in range(1, MAX_WIDTH + 1):
        sel = np.nonzero(bits == b)[0]
        if sel.size == 0:
            continue
        byte_idx, bit_off = tables[b]
        rows = vpad[offs[sel][:, None] + np.arange(row_len, dtype=np.int64)]
        rows = rows.astype(np.int32)
        lo = rows[:, byte_idx] >> bit_off
        hi = rows[:, byte_idx + 1] << (8 - bit_off)
        out[sel] = ((lo | hi) & ((1 << b) - 1)).astype(np.uint8)
    return out.reshape(-1)[:output_size]


def compressed_size(data: np.ndarray, frame_length: int = FRAME_LENGTH) -> int:
    """Container payload size (bits + values) the encoder will produce."""
    data = np.asarray(data, np.uint8)
    n = data.size
    if n == 0:
        return 0
    nframes, counts = frame_geometry(n, frame_length)
    padded = np.zeros(nframes * frame_length, np.uint8)
    padded[:n] = data
    bits = frame_bits(padded, frame_length).astype(np.int64)
    return int(nframes + ((counts * bits + 7) // 8).sum())
