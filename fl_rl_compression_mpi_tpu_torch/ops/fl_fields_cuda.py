"""FL field-form kernels on the GPU, each beside its plain PyTorch version.

Counterpart of ``fl_rl_compression_mpi_tpu/ops/fl_pallas.py``.  The kernels
live in ``csrc/fl_fields.cu``; their wrappers here are

===================  ================================================
``encode_fields``    per-frame width + each word's 4·b-bit field
``decode_fields``    fields + widths → words (the inverse spread)
===================  ================================================

Each takes a pack-2 mode (``tile_r`` > 0): two 16-bit fields a u32, the tile
halves of ``tile_r`` rows of 128 words (the layout of
``fl_encode_fields_packed_pallas``), valid only where every width is ≤ 4.
Words and fields are u32 values carried as int32 bit-views: on the CPU,
``torch.uint32`` has no shifts, ``max`` or comparisons, so the plain
versions compute in int64.

A wrapper given CPU tensors returns its plain PyTorch version (``*_ref``);
given CUDA tensors it launches its kernel on the current stream or raises.
It never falls back from one to the other.  Each launch adds one to
``LAUNCHES[<kernel>]``, pack-2 launches under the ``*_p2`` keys.

The encoders carry no tail mask: bytes past the stream's end must be zero,
or they widen the last frame.  Decoded bytes past the end are unspecified.
"""

from __future__ import annotations

import torch

from .bitpack import FRAME_LENGTH
from .fl_dense_cuda import (_aligned, _check, _launch, _on_cuda, _stream,
                            count_launch, reset_table)

LANES = 128

LAUNCHES = {"fl_fields_encode": 0, "fl_fields_encode_p2": 0,
            "fl_fields_decode": 0, "fl_fields_decode_p2": 0}


def reset_launches() -> None:
    reset_table(LAUNCHES)


def packed_words(nw: int, tile_r: int) -> int:
    """u32 words of the pack-2 layout that hold fields 0..nw-1: half of
    every tile they touch."""
    tile_w = tile_r * LANES
    return -(-nw // tile_w) * (tile_w // 2)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (int64 arithmetic on u32 values).
# ---------------------------------------------------------------------------

def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFFFFFF


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → their int32 bit-view."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _per_word(bits: torch.Tensor, wpf: int) -> torch.Tensor:
    F = bits.numel()
    return bits.to(torch.int64).view(F, 1).expand(F, wpf).reshape(-1)


def encode_fields_ref(words: torch.Tensor,
                      frame_length: int = FRAME_LENGTH, tile_r: int = 0):
    """``(bits u8[F], out int32)``: width max(1, bitlen(max byte)) per frame
    of wpf = L/4 words, and each word's field e0|e1<<b|e2<<2b|e3<<3b —
    ``out`` int32[NW] in base mode, the pack-2 layout int32[NW/2] (each
    field's low 16 bits) when ``tile_r`` > 0.  As ``fl_jax.fl_encode_fields``
    with every byte past the end zero."""
    wpf = frame_length // 4
    w = _u32(words)
    o = w | (w >> 16)
    o = (o | (o >> 8)) & 0xFF
    fo = o.view(-1, wpf).amax(dim=1)
    bits = torch.ones_like(fo)
    for k in range(1, 8):
        bits += (fo >= (1 << k)).to(torch.int64)
    b = _per_word(bits, wpf)
    f = ((w & 0xFF) | (((w >> 8) & 0xFF) << b) | (((w >> 16) & 0xFF) << 2 * b)
         | ((w >> 24) << 3 * b))
    if tile_r:
        q = tile_r // 2
        t = f.view(-1, tile_r, LANES) & 0xFFFF
        f = (t[:, :q] | (t[:, q:] << 16)).reshape(-1)
    return bits.to(torch.uint8), _i32(f)


def decode_fields_ref(fields: torch.Tensor, bits: torch.Tensor,
                      frame_length: int = FRAME_LENGTH,
                      tile_r: int = 0) -> torch.Tensor:
    """Words int32[F·wpf] of the fields (base mode) or pack-2 slots
    (``tile_r`` > 0) and the widths ``bits`` u8[F] — as
    ``fl_jax.fl_decode_fields`` without its tail mask."""
    wpf = frame_length // 4
    nw = bits.numel() * wpf
    f = _u32(fields)
    if tile_r:
        q = tile_r // 2
        p = f[:packed_words(nw, tile_r)].view(-1, q, LANES)
        f = torch.cat([p & 0xFFFF, p >> 16], dim=1).reshape(-1)
    f = f[:nw]
    b = _per_word(bits, wpf)
    m = (1 << b) - 1
    w = ((f & m) | (((f >> b) & m) << 8) | (((f >> 2 * b) & m) << 16)
         | (((f >> 3 * b) & m) << 24))
    return _i32(w)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def _check_geometry(nw: int, frame_length: int, tile_r: int) -> int:
    if frame_length <= 0 or frame_length % 8:
        raise ValueError(f"frame_length must be a positive multiple of 8, "
                         f"got {frame_length}")
    wpf = frame_length // 4
    if nw % wpf:
        raise ValueError(f"{nw} words are not a whole number of "
                         f"{wpf}-word frames")
    if tile_r and (tile_r < 0 or tile_r % 16 or LANES % wpf):
        raise ValueError(f"pack-2 needs tile_r % 16 == 0 and 128 % wpf == 0, "
                         f"got tile_r={tile_r}, wpf={wpf}")
    return wpf


def encode_fields(words: torch.Tensor, frame_length: int = FRAME_LENGTH,
                  tile_r: int = 0):
    """``(bits u8[F], out int32)`` of ``words`` int32[NW] (NW a frame
    multiple; a multiple of tile_r·128 in pack-2 mode); see
    :func:`encode_fields_ref`.  Pack-2 output is valid only where every
    width is ≤ 4: check ``bits`` first.  The kernel takes at most 2^29
    words (2^31 bytes) a call, 16-byte aligned."""
    _check(words, "words", torch.int32)
    nw = words.numel()
    wpf = _check_geometry(nw, frame_length, tile_r)
    if tile_r and nw % (tile_r * LANES):
        raise ValueError(f"pack-2 encode needs whole tiles: {nw} words, "
                         f"tile_r={tile_r}")
    if not _on_cuda(words):
        return encode_fields_ref(words, frame_length, tile_r)
    _aligned(words, "words")
    bits = torch.empty(nw // wpf, dtype=torch.uint8, device=words.device)
    out = torch.empty(nw // 2 if tile_r else nw, dtype=torch.int32,
                      device=words.device)
    _launch("flrl_fields_encode", words.data_ptr(), nw, frame_length, tile_r,
            bits.data_ptr(), out.data_ptr(), words.device.index,
            _stream(words))
    count_launch(LAUNCHES, "fl_fields_encode_p2" if tile_r
                 else "fl_fields_encode", words.device)
    return bits, out


def decode_fields(fields: torch.Tensor, bits: torch.Tensor,
                  frame_length: int = FRAME_LENGTH,
                  tile_r: int = 0) -> torch.Tensor:
    """Words int32[F·wpf] of ``fields`` (int32[F·wpf], or in pack-2 mode
    at least ``packed_words(F·wpf, tile_r)`` slots words) and the widths
    ``bits`` u8[F], each 1..8; see :func:`decode_fields_ref`.  The kernel
    takes at most 2^29 output words (2^31 bytes) a call, pack-2 tiles of
    at most 2^29 words, and 16-byte aligned ``fields``; it raises on more
    (the field route's chunks are at most 1 GiB)."""
    _check(fields, "fields", torch.int32)
    _check(bits, "bits", torch.uint8)
    nw = bits.numel() * (frame_length // 4)
    _check_geometry(nw, frame_length, tile_r)
    need = packed_words(nw, tile_r) if tile_r else nw
    if fields.numel() < need or (not tile_r and fields.numel() != nw):
        raise ValueError(f"fields: expected {need} words for {bits.numel()} "
                         f"frames, got {fields.numel()}")
    if not _on_cuda(fields, bits):
        return decode_fields_ref(fields, bits, frame_length, tile_r)
    _aligned(fields, "fields")
    out = torch.empty(nw, dtype=torch.int32, device=fields.device)
    _launch("flrl_fields_decode", fields.data_ptr(), bits.data_ptr(), nw,
            frame_length, tile_r, out.data_ptr(), fields.device.index,
            _stream(fields))
    count_launch(LAUNCHES, "fl_fields_decode_p2" if tile_r
                 else "fl_fields_decode", fields.device)
    return out
