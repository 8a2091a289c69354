"""FL codec on one device: the host dispatch around the dense kernels.

Counterpart of ``fl_rl_compression_mpi_tpu/ops/fl_jax.py`` (its dense
path).  One dispatch chain serves every input size:

* encode — constant stream → closed-form container on the host; else a
  walk over frame-aligned chunks of at most ``_device_cap(L)`` bytes, each
  copied to the device, its widths computed with the uniform-mode flag
  when the host probe sees a uniform first tile, packed in uniform mode
  on a clean flag or else through the offsets scan and the general pack,
  and copied back (the widths and exactly the payload's bytes);
* decode — constant container → memset; all-8 widths → the payload is
  the output; else the same chunk walk, with a uniform widths header
  taking uniform mode and any other the offsets scan and general unpack.

The codec has no weights: its state is the container.  Encode and decode
read and write the same ``FLCompressed`` fields and file bytes as the JAX
package (``fl_rl_compression_mpi_tpu.container``), so containers cross
between the two packages as they are, with no conversion.

``device`` is explicit: a CUDA device runs the kernels, the CPU runs their
plain PyTorch versions (the tests use it).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from fl_rl_compression_mpi_tpu.ops.bitpack import FRAME_LENGTH
from fl_rl_compression_mpi_tpu.utils import constant_byte_probe

from ..utils.timers import stage
from . import fl_dense_cuda as kern

# Largest chunk one device pass takes.  The kernels index with int64, but
# the walk keeps the 1 GiB bound so a chunk's buffers stay a few GiB.
# Chunks are frame-aligned, so the output does not depend on the cap.
MAX_DEVICE_CHUNK = 1 << 30


def _device_cap(frame_length: int) -> int:
    return (MAX_DEVICE_CHUNK // frame_length) * frame_length


def _constant_frame_pattern(c: int, fb: int,
                            frame_length: int) -> np.ndarray:
    """One full frame's packed payload for a constant byte ``c`` at
    width ``fb``: the LSB-first repetition of c's fb bits over
    frame_length·fb bits — a byte cycle of period fb (frames restart
    the phase, so every full frame is this same block)."""
    nbytes = frame_length * fb // 8
    cbits = np.array([(c >> k) & 1 for k in range(fb)], np.uint8)
    stream = np.tile(cbits, nbytes * 8 // fb)
    return np.packbits(stream, bitorder="little")  # LSB-first per byte


def _constant_container(c: int, n: int, frame_length: int):
    """Closed-form FL container of ``n`` bytes of constant ``c``
    (any width 1..8, any tail): widths all fb; payload = the per-frame
    byte cycle, with the tail frame truncated to ceil(counts·fb/8)
    bytes and its last partial byte masked."""
    fb = max(1, int(c).bit_length())
    frames = -(-n // frame_length)
    bits = np.full(frames, fb, np.uint8)
    pat = _constant_frame_pattern(c, fb, frame_length)
    tail_count = n - (frames - 1) * frame_length
    tail_bits = tail_count * fb
    tail_len = -(-tail_bits // 8)
    values = np.tile(pat, frames)[: (frames - 1) * pat.size + tail_len]
    if tail_bits % 8:
        values[-1] &= (1 << (tail_bits % 8)) - 1
    return bits, values


def host_constant_decode_probe(bits: np.ndarray, values: np.ndarray,
                               n: int,
                               frame_length: int = FRAME_LENGTH
                               ) -> int | None:
    """Returns the constant byte when the container is EXACTLY the
    closed form (uniform widths + repeating frame pattern, verified by a
    cheap prefix probe and then an exact full compare), else None — a
    mismatch falls through to the device paths."""
    frames = -(-n // frame_length)
    if (frame_length % 8 or not frames or not values.size
            or bits.size < frames):
        return None
    ba = bits[:frames]
    if not bool((ba == ba[0]).all()):
        return None
    fbu = int(ba[0])
    c = int(values[0]) & ((1 << fbu) - 1)
    if max(1, c.bit_length()) != fbu:
        return None
    # prefix probe against the repeating frame pattern (valid strictly
    # before the last byte — only the tail frame's final byte is
    # masked), THEN the exact full compare
    pat = _constant_frame_pattern(c, fbu, frame_length)
    probe = min(values.size - 1, 128 << 10)
    pre = np.tile(pat, -(-probe // pat.size) + 1)[:probe]
    if not bool((values[:probe] == pre).all()):
        return None
    _, ev = _constant_container(c, n, frame_length)
    if values.size == ev.size and bool((values == ev).all()):
        return c
    return None


def host_identity_decode_probe(bits: np.ndarray, values: np.ndarray,
                               n: int,
                               frame_length: int = FRAME_LENGTH):
    """Width-8 identity: packing bytes at width 8 is the identity, so an
    all-8 widths header means the payload IS the output — one copy, no
    device work.  Returns the decoded bytes or None."""
    frames = -(-n // frame_length)
    if not frames or bits.size < frames or values.size < n:
        return None
    ba = bits[:frames]
    if bool((ba == 8).all()):
        return values[:n].copy()
    return None


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    with warnings.catch_warnings():
        # read-only inputs (np.frombuffer, container views) are only read
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def encode(data, frame_length: int = FRAME_LENGTH, *,
           device: str | torch.device):
    """u8 bytes → ``(bits u8[F], values u8[V])``, byte-identical to
    ``fl_numpy.encode`` and to the reference binary's containers."""
    kern.check_frame_length(frame_length)
    data = np.asarray(data, np.uint8).reshape(-1)
    n = data.size
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
    c = constant_byte_probe(data)
    if c is not None:
        with stage("Compression", n):
            return _constant_container(c, n, frame_length)
    device = torch.device(device)
    cap = _device_cap(frame_length)
    parts = [_encode_chunk(data[off:off + cap], frame_length, device)
             for off in range(0, n, cap)]
    if len(parts) == 1:
        return parts[0]
    return (np.concatenate([b for b, _ in parts]),
            np.concatenate([v for _, v in parts]))


def _encode_chunk(chunk: np.ndarray, frame_length: int,
                  device: torch.device):
    n = chunk.size
    h2d = []
    with stage("Copy input data to device", n, result=h2d):
        x = _to_device(chunk, device)
        h2d.append(x)
    fb = kern.host_probe_uniform_b(chunk, frame_length) or 0
    krn = []
    with stage("Compression", n, result=krn):
        bits_d, flag = kern.frame_widths(x, frame_length, fb_expect=fb)
        if fb and int(flag.item()) == 0:
            values_d = kern.pack(x, frame_length, fb=fb)
        else:
            offs = kern.frame_offsets(bits_d, n, frame_length)
            values_d = kern.pack(x, frame_length, bits=bits_d, offs=offs)
        krn += [bits_d, values_d]
    with stage("Copy results to CPU") as t:
        bits = bits_d.cpu().numpy()
        values = values_d.cpu().numpy()
        if t:
            t.add_transfer_size(bits.size + values.size)
    return bits, values


def decode(output_size: int, bits, values,
           frame_length: int = FRAME_LENGTH, *,
           device: str | torch.device) -> np.ndarray:
    """Container → u8[output_size].  Rejects, before any device work, a
    widths array shorter than the frame count, a width byte outside 1..8
    and a payload shorter than the widths imply."""
    kern.check_frame_length(frame_length)
    bits = np.asarray(bits, np.uint8).reshape(-1)
    values = np.asarray(values, np.uint8).reshape(-1)
    n = int(output_size)
    if n == 0:
        return np.zeros(0, np.uint8)
    frames = -(-n // frame_length)
    if bits.size < frames:
        raise ValueError(
            "fl decode: corrupt container (bits array shorter than "
            f"frame count: {bits.size} < {frames})")
    c = host_constant_decode_probe(bits, values, n, frame_length)
    if c is not None:
        with stage("Decompression", n):
            return np.full(n, c, np.uint8)
    out8 = host_identity_decode_probe(bits, values, n, frame_length)
    if out8 is not None:
        with stage("Decompression", n):
            return out8
    widths = bits[:frames]
    lo, hi = int(widths.min()), int(widths.max())
    if lo < 1 or hi > 8:
        raise ValueError(
            "fl decode: corrupt container (width byte outside 1..8: "
            f"{lo if lo < 1 else hi})")
    counts = np.minimum(
        n - np.arange(frames, dtype=np.int64) * frame_length, frame_length)
    voffs = np.zeros(frames + 1, np.int64)
    np.cumsum((widths.astype(np.int64) * counts + 7) // 8, out=voffs[1:])
    if values.size < voffs[-1]:
        raise ValueError(
            "fl decode: corrupt container (payload shorter than the "
            f"widths imply: {values.size} < {int(voffs[-1])})")
    fb = lo if lo == hi else 0
    device = torch.device(device)
    cap = _device_cap(frame_length)
    fpc = cap // frame_length
    out = np.empty(n, np.uint8)
    for off in range(0, n, cap):
        f0 = off // frame_length
        f1 = min(f0 + fpc, frames)
        _decode_chunk(out[off:off + cap], widths[f0:f1],
                      values[voffs[f0]:voffs[f1]], frame_length, device, fb)
    return out


def _decode_chunk(out: np.ndarray, bits: np.ndarray, values: np.ndarray,
                  frame_length: int, device: torch.device, fb: int) -> None:
    """Decode one chunk's container into ``out`` (its bytes of the
    output), copying from the device straight into it."""
    n = out.size
    h2d = []
    with stage("Copy input to device", values.size + bits.size, result=h2d):
        v = _to_device(values, device)
        b = None if fb else _to_device(bits, device)
        h2d.append(v)
    krn = []
    with stage("Decompression", n, result=krn):
        if fb:
            out_d = kern.unpack(v, n, frame_length, fb=fb)
        else:
            offs = kern.frame_offsets(b, n, frame_length)
            out_d = kern.unpack(v, n, frame_length, bits=b, offs=offs)
        krn.append(out_d)
    with stage("Copy results to CPU", n):
        torch.from_numpy(out).copy_(out_d)
