"""On-disk container formats.

FL container — byte-for-byte the reference layout
(``reference/src/file_io.cu:222-280`` write, ``:117-192`` read)::

    [inputSize u64][bitsSize u64][valuesSize u64][bits u8*bitsSize][values u8*valuesSize]

little-endian, 24-byte header.  Files produced here decompress with the CUDA
reference and vice versa.

RL container — the reference never defined one (the RL codec exists only as
the spec in ``reference/IMPLEMENTATION-PLAN.md:81-179``); we mirror the
FL header style::

    [inputSize u64][countsSize u64][valuesSize u64][counts u8*][values u8*]

where ``counts[i]`` is the (1..255) run length of ``values[i]``.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

_HEADER = struct.Struct("<QQQ")

FL_MAGICLESS_HEADER_BYTES = _HEADER.size  # 24; the reference has no magic


@dataclasses.dataclass
class FLCompressed:
    """Host-side compressed FL payload (reference ``FLCompressed``,
    ``reference/src/fl/fl_common.cuh:11-34``)."""
    bits: np.ndarray      # u8[frames]
    values: np.ndarray    # u8[ceil(total_bits/8)]
    input_size: int

    def merge(self, *others: "FLCompressed") -> "FLCompressed":
        """Rank-ordered concatenation merge (reference ``MergeFLCompressed``,
        ``fl_common.cuh:95-151``): bits‖bits‖…, values‖values‖…, Σ sizes.
        Lossless because shard boundaries are frame-aligned (SURVEY.md
        finding #3)."""
        parts = (self,) + others
        return FLCompressed(
            bits=np.concatenate([p.bits for p in parts]),
            values=np.concatenate([p.values for p in parts]),
            input_size=sum(p.input_size for p in parts),
        )


@dataclasses.dataclass
class RLCompressed:
    """Host-side compressed RL payload: parallel (count, value) u8 arrays."""
    counts: np.ndarray    # u8[runs], each 1..255
    values: np.ndarray    # u8[runs]
    input_size: int

    def merge(self, *others: "RLCompressed") -> "RLCompressed":
        parts = (self,) + others
        return RLCompressed(
            counts=np.concatenate([p.counts for p in parts]),
            values=np.concatenate([p.values for p in parts]),
            input_size=sum(p.input_size for p in parts),
        )


def _read_exact(f, n: int) -> bytes:
    buf = f.read(n)
    if len(buf) != n:
        raise IOError("[FileIO] Cannot read file content")
    return buf


def save_fl(path: str, comp: FLCompressed) -> None:
    bits = np.ascontiguousarray(comp.bits, np.uint8)
    values = np.ascontiguousarray(comp.values, np.uint8)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(int(comp.input_size), bits.size, values.size))
        bits.tofile(f)
        values.tofile(f)


def load_fl(path: str) -> FLCompressed:
    with open(path, "rb") as f:
        input_size, bits_size, values_size = _HEADER.unpack(
            _read_exact(f, _HEADER.size))
        bits = np.frombuffer(_read_exact(f, bits_size), np.uint8)
        values = np.frombuffer(_read_exact(f, values_size), np.uint8)
    return FLCompressed(bits=bits, values=values, input_size=input_size)


def save_rl(path: str, comp: RLCompressed) -> None:
    counts = np.ascontiguousarray(comp.counts, np.uint8)
    values = np.ascontiguousarray(comp.values, np.uint8)
    if counts.size != values.size:
        raise ValueError("RL counts/values length mismatch")
    with open(path, "wb") as f:
        f.write(_HEADER.pack(int(comp.input_size), counts.size, values.size))
        counts.tofile(f)
        values.tofile(f)


def load_rl(path: str) -> RLCompressed:
    with open(path, "rb") as f:
        input_size, counts_size, values_size = _HEADER.unpack(
            _read_exact(f, _HEADER.size))
        if counts_size != values_size:
            raise IOError(
                "[FileIO] corrupt RL container: counts/values size "
                f"mismatch ({counts_size} != {values_size})")
        counts = np.frombuffer(_read_exact(f, counts_size), np.uint8)
        values = np.frombuffer(_read_exact(f, values_size), np.uint8)
    return RLCompressed(counts=counts, values=values, input_size=input_size)
