"""FL codec on one device: the host dispatch around the FL kernels.

Counterpart of ``fl_rl_compression_mpi_tpu/ops/fl_jax.py``.  One dispatch
chain serves every input size and both device routes:

* encode — constant stream → closed-form container on the host; else a
  walk over frame-aligned chunks of at most ``_device_cap(L)`` bytes, each
  copied to the device and encoded by one of two routes:

  - the **dense route** (the default, every frame length): widths computed
    with the uniform-mode flag when the host probe sees a uniform first
    tile, packed in uniform mode on a clean flag or else through the
    offsets scan and the general pack, and copied back (the widths and
    exactly the payload's bytes);
  - the **field route** (``FLRL_NO_DENSE=1``): the device writes widths and
    fields, and the host folds the fields into the payload.  Where
    128 % (L/4) == 0 it first speculates on pack-2 (two 16-bit fields a
    word, valid when every width is ≤ 4) and re-runs the base field
    encode on a miss;

* decode — constant container → memset; all-8 widths → the payload is
  the output; else the same chunk walk: on the dense route a uniform
  widths header takes uniform mode and any other the offsets scan and
  general unpack; on the field route the host unfolds the payload into
  fields (pack-2 where every width of the chunk is ≤ 4) and the device
  decodes them.

The JAX package takes the dense route only on a TPU at L = 128 and the
field route everywhere else.  Here the dense kernels place bytes for every
frame length, so dense is the default for every L and the field route runs
where an operator asks for it with the JAX package's own switch, which is
read at each call.  The JAX package's ``FLRL_NO_PACK`` is not read: the
field route always speculates on pack-2 where the layout allows, and the
container is the same either way.

The codec has no weights: its state is the container.  Encode and decode
read and write the same ``FLCompressed`` fields and file bytes as the JAX
package (this package's ``container.py`` is a copy of
``fl_rl_compression_mpi_tpu/container.py``), so containers cross between
the two packages as they are, with no conversion.

``device`` is explicit: a CUDA device runs the kernels, the CPU runs their
plain PyTorch versions (the tests use it).
"""

from __future__ import annotations

import functools
import os
import warnings

import numpy as np
import torch

from ..utils import constant_byte_probe
from ..utils.timers import stage
from . import fl_dense_cuda as kern
from . import fl_fields_cuda as fkern
from .bitpack import FRAME_LENGTH
from .fields import fold, fold_p2, unfold, unfold_p2

# Largest chunk one device pass takes.  The kernels index with int64, but
# the walk keeps the 1 GiB bound so a chunk's buffers stay a few GiB.
# Chunks are frame-aligned, so the output does not depend on the cap.
MAX_DEVICE_CHUNK = 1 << 30

# Rows of 128 words in one pack-2 tile, the layout unit that the field
# encoder, the host fold and the decoder share (the JAX package's 2048).
PACK_TILE_R = 2048


def _device_cap(frame_length: int) -> int:
    return (MAX_DEVICE_CHUNK // frame_length) * frame_length


def _use_dense() -> bool:
    """The dense route, unless ``FLRL_NO_DENSE=1`` asks for the field
    route."""
    return os.environ.get("FLRL_NO_DENSE") != "1"


def _use_pack2(frame_length: int) -> bool:
    """Pack-2 speculation on the field route: the layout needs whole frames
    in a 128-word row."""
    return 128 % (frame_length // 4) == 0


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


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    with warnings.catch_warnings():
        # read-only inputs (np.frombuffer, container views) are only read
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.ascontiguousarray(a))


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return _host_tensor(a).to(device)


def _staged(chunk: np.ndarray, size: int,
            device: torch.device) -> torch.Tensor:
    """``chunk`` on the device at the start of a ``size``-byte buffer whose
    rest is zero: the field encoders carry no tail mask, and a non-zero
    pad byte would widen the last frame."""
    buf = torch.empty(size, dtype=torch.uint8, device=device)
    buf[chunk.size:].zero_()
    buf[:chunk.size].copy_(_host_tensor(chunk))
    return buf


def encode_fields_device(words: torch.Tensor,
                         frame_length: int = FRAME_LENGTH,
                         pack: bool = False):
    """Field encode of ``words`` int32[NW] (u32 bit-views, NW a frame
    multiple; with ``pack`` a multiple of ``PACK_TILE_R``·128): the base
    field kernel, or the pack-2 one at this module's tile.  Returns ``(bits
    u8[F], fields int32[NW])`` or ``(bits, packed int32[NW/2])``.  As
    ``fl_jax.encode_fields_device`` but with no ``n``: bytes past the
    stream's end must be zero."""
    return fkern.encode_fields(words, frame_length,
                               PACK_TILE_R if pack else 0)


def decode_fields_device(fields_d: torch.Tensor, bits_d: torch.Tensor,
                         frame_length: int = FRAME_LENGTH,
                         pack: bool = False) -> torch.Tensor:
    """Words int32[F·wpf] of the fields (or, with ``pack``, the pack-2
    layout at this module's tile) and the widths ``bits_d`` u8[F].  As
    ``fl_jax.decode_fields_device``; bytes past the stream's end are
    unspecified."""
    return fkern.decode_fields(fields_d, bits_d, frame_length,
                               PACK_TILE_R if pack else 0)


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
    return encode_walk(data, frame_length, device)


def encode_walk(data: np.ndarray, frame_length: int,
                device: str | torch.device, to_host: bool = True):
    """The chunk walk of :func:`encode`, with no host closed form: ``data``
    in frame-aligned chunks of at most ``_device_cap(L)`` bytes, each through
    the route ``FLRL_NO_DENSE`` selects.  Returns ``(bits, values)`` as NumPy
    arrays, or with ``to_host=False`` as u8 tensors on ``device`` (the dense
    route's stay where the kernels wrote them; the field route's payload,
    folded on the host, is copied up)."""
    device = torch.device(device)
    n = data.size
    cap = _device_cap(frame_length)
    if _use_dense():
        chunk_fn = _encode_chunk if to_host else _encode_chunk_device
    else:
        chunk_fn = _encode_fields_chunk
    parts = [chunk_fn(data[off:off + cap], frame_length, device)
             for off in range(0, n, cap)]
    if to_host:
        if len(parts) == 1:
            return parts[0]
        if not parts:
            return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
        return (np.concatenate([b for b, _ in parts]),
                np.concatenate([v for _, v in parts]))
    parts = [tuple(x if isinstance(x, torch.Tensor) else _to_device(x, device)
                   for x in part) for part in parts]
    if len(parts) == 1:
        return parts[0]
    empty = [torch.zeros(0, dtype=torch.uint8, device=device)]
    return (torch.cat([b for b, _ in parts] + empty),
            torch.cat([v for _, v in parts] + empty))


def _encode_chunk_device(chunk: np.ndarray, frame_length: int,
                         device: torch.device):
    """The dense route's encode of one chunk, left on the device:
    ``(bits_d u8[F], values_d u8[V])``."""
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
    return bits_d, values_d


def _encode_chunk(chunk: np.ndarray, frame_length: int,
                  device: torch.device):
    bits_d, values_d = _encode_chunk_device(chunk, frame_length, device)
    with stage("Copy results to CPU") as t:
        bits = bits_d.cpu().numpy()
        values = values_d.cpu().numpy()
        if t:
            t.add_transfer_size(bits.size + values.size)
    return bits, values


def _encode_fields_chunk(chunk: np.ndarray, frame_length: int,
                         device: torch.device):
    """The field route's encode of one chunk: pack-2 speculation where the
    layout allows, else (or on a miss) the base field encode; then the host
    fold."""
    n = chunk.size
    L = frame_length
    wpf = L // 4
    frames = -(-n // L)
    pack = _use_pack2(L)
    unit = PACK_TILE_R * fkern.LANES * 4 if pack else L
    h2d = []
    with stage("Copy input data to device", n, result=h2d):
        buf = _staged(chunk, -(-n // unit) * unit, device)
        h2d.append(buf)
    words = buf.view(torch.int32)
    if pack:
        krn = []
        with stage("Compression", n, result=krn):
            bits_d, packed_d = encode_fields_device(words, L, pack=True)
            krn += [bits_d, packed_d]
        bits = bits_d[:frames].cpu().numpy()
        if int(bits.max()) <= 4:
            need = fkern.packed_words(frames * wpf, PACK_TILE_R)
            with stage("Copy results to CPU", frames + need * 4):
                packed = packed_d[:need].cpu().numpy().view(np.uint32)
            with stage("Host fold (ragged placement)", n):
                return bits, fold_p2(packed, bits, n, L, PACK_TILE_R)
        # speculation miss (some width > 4): the base encode of the words
        # still on the device
    krn = []
    with stage("Compression", n, result=krn):
        bits_d, fields_d = encode_fields_device(words[:frames * wpf], L)
        krn += [bits_d, fields_d]
    with stage("Copy results to CPU", frames + frames * wpf * 4):
        bits = bits_d.cpu().numpy()
        fields_h = fields_d.cpu().numpy().view(np.uint32)
    with stage("Host fold (ragged placement)", n):
        return bits, fold(fields_h, bits, n, L)


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
    out = decode_closed_form(n, bits, values, frame_length)
    if out is not None:
        return out
    widths, voffs = container_layout(n, bits, values, frame_length)
    return decode_walk(n, widths, values, voffs, frame_length, device)


def decode_closed_form(n: int, bits: np.ndarray, values: np.ndarray,
                       frame_length: int) -> np.ndarray | None:
    """The host closed forms of decode, tried before any device work: the
    constant container becomes a memset, all-8 widths mean the payload is
    the output.  Returns the n decoded bytes, or None.  Raises when the
    widths array is shorter than the frame count."""
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
    return None


def container_layout(n: int, bits: np.ndarray, values: np.ndarray,
                     frame_length: int):
    """``(widths u8[F], voffs i64[F+1])``: the widths of the frames of an
    n-byte stream and the exclusive scan of their payload bytes.  Raises
    on a width byte outside 1..8 or a payload shorter than the widths
    imply."""
    frames = -(-n // frame_length)
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
    return widths, voffs


def decode_walk(n: int, widths: np.ndarray, values: np.ndarray,
                voffs: np.ndarray, frame_length: int,
                device: str | torch.device) -> np.ndarray:
    """The chunk walk of :func:`decode`, with no host closed form: the n
    bytes of the frames ``widths`` (each 1..8) whose payload starts at
    ``values[voffs[f]]``, decoded chunk by chunk on the route
    ``FLRL_NO_DENSE`` selects."""
    out = np.empty(n, np.uint8)
    if n == 0:
        return out
    lo, hi = int(widths.min()), int(widths.max())
    chunk_fn = (functools.partial(_decode_chunk, fb=lo if lo == hi else 0)
                if _use_dense() else _decode_fields_chunk)
    device = torch.device(device)
    cap = _device_cap(frame_length)
    fpc = cap // frame_length
    frames = widths.size
    for off in range(0, n, cap):
        f0 = off // frame_length
        f1 = min(f0 + fpc, frames)
        chunk_fn(out[off:off + cap], widths[f0:f1],
                 values[voffs[f0]:voffs[f1]], frame_length, device)
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


def _decode_fields_chunk(out: np.ndarray, bits: np.ndarray,
                         values: np.ndarray, frame_length: int,
                         device: torch.device) -> None:
    """The field route's decode of one chunk into ``out``: the host unfolds
    the payload into fields (the pack-2 layout where the layout allows and
    every width of the chunk is ≤ 4), the device decodes them, and the
    result is copied straight into ``out``."""
    n = out.size
    L = frame_length
    nw = bits.size * (L // 4)
    pack = _use_pack2(L) and int(bits.max()) <= 4
    with stage("Host unfold (ragged placement)", n):
        if pack:
            fields_h = unfold_p2(values, bits, n, L, PACK_TILE_R,
                                 fkern.packed_words(nw, PACK_TILE_R))
        else:
            fields_h = unfold(values, bits, n, L)
    h2d = []
    with stage("Copy input to device", fields_h.nbytes + bits.size,
               result=h2d):
        f = _to_device(fields_h.view(np.int32), device)
        b = _to_device(bits, device)
        h2d += [f, b]
    krn = []
    with stage("Decompression", n, result=krn):
        out_d = decode_fields_device(f, b, L, pack=pack)
        krn.append(out_d)
    with stage("Copy results to CPU", n):
        torch.from_numpy(out).copy_(out_d.view(torch.uint8)[:n])
