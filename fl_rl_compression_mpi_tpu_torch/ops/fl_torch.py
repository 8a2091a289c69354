"""FL codec on one device: the host dispatch around the FL kernels.

Counterpart of ``fl_rl_compression_mpi_tpu/ops/fl_jax.py``.  One walk
serves every caller (whole-file, a rank's shard, a stream) and both device
routes: :func:`encode_chunks` and :func:`decode_chunks`, frame-aligned
chunks of at most ``_device_cap(L)`` bytes, pipelined.  A chunk is
*submitted* (copied up through a pinned buffer and its kernels launched,
with nothing read back from the device) and *drained* one chunk later
(whatever the host must decide after the kernels, and the copy down), so
that a chunk's copy down and host work overlap the next chunk's copy up
and kernels, as in the JAX package's ``encode_chunks``/``decode_chunks``:

* encode — a constant chunk → the closed-form container on the host; else
  one of two routes:

  - the **dense route** (the default, every frame length): widths computed
    with the uniform-mode flag and the uniform pack launched at once when
    the host probe sees a uniform first tile, else the offsets scan and
    the general pack; at drain a raised flag re-runs the general pack on
    the input kept for it, and exactly the payload's bytes, sized from the
    widths, are copied down;
  - the **field route** (``FLRL_NO_DENSE=1``): the device writes widths and
    fields, and the host folds the fields into the payload at drain.
    Where 128 % (L/4) == 0 it speculates on pack-2 (two 16-bit fields a
    word, valid when every width is ≤ 4), judged at drain, where a miss
    re-runs the base field encode on the words kept for it;

* decode — a constant container → memset; all-8 widths → the payload is
  the output; else on the dense route a uniform chunk takes uniform mode
  and any other the offsets scan and general unpack; on the field route
  the host unfolds the payload into fields at submit (pack-2 where every
  width of the chunk is ≤ 4), while the device still decodes the chunk
  before, and the device decodes them.

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

import os
import threading
import warnings
from collections import deque

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
    if _all_eight(bits, values, n, frame_length):
        return values[:n].copy()
    return None


def _all_eight(bits: np.ndarray, values: np.ndarray, n: int,
               frame_length: int) -> bool:
    frames = -(-n // frame_length)
    return bool(frames and bits.size >= frames and values.size >= n
                and (bits[:frames] == 8).all())


# ``warnings.catch_warnings`` swaps the process's filters: the per-card
# threads of a mesh must not interleave their swaps
_WARNINGS_LOCK = threading.Lock()


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    with _WARNINGS_LOCK, warnings.catch_warnings():
        # read-only inputs (np.frombuffer, container views) are only read
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.ascontiguousarray(a))


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return _host_tensor(a).to(device)


def payload_size(bits: np.ndarray, n: int, frame_length: int) -> int:
    """Payload bytes of the n-byte stream whose frames have the widths
    ``bits`` (each 1..8): every frame but the last packs L·b/8 bytes."""
    if n == 0:
        return 0
    tail = n - (bits.size - 1) * frame_length
    return (frame_length // 8 * int(bits[:-1].sum(dtype=np.int64))
            + -(-int(bits[-1]) * tail // 8))


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


def _pinned_bytes(nbytes: int) -> torch.Tensor:
    """Pinned host bytes, at least ``nbytes``, rounded up to a power of two
    as PyTorch's pinned-memory cache rounds them anyway."""
    return torch.empty(1 << max(nbytes - 1, 0).bit_length(),
                       dtype=torch.uint8, pin_memory=True)


class _Lanes:
    """Where a walk's chunks move.  On a CUDA device: an upload stream, the
    caller's current stream for the kernels, and a download stream, with
    pinned host buffers that the chunks of one call reuse.  On the CPU
    none of these: the plain versions run in order.

    Nothing here reads the device back but :meth:`wait` and
    :meth:`download`, which wait on events, so a walk's submit never
    waits for the device."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.depth = depth
        self.turn = 0               # the chunk being submitted, modulo depth
        self._up = {}               # (turn, slot) -> (pinned u8, event)
        self._down = None           # pinned u8
        # the kernels' stream and the copy streams (None on the CPU)
        self.compute = self.up_stream = self.down_stream = None
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.up_stream = torch.cuda.Stream(device)
            self.down_stream = torch.cuda.Stream(device)

    def next_chunk(self) -> None:
        self.turn = (self.turn + 1) % self.depth

    def _pinned(self, key, nbytes: int) -> torch.Tensor:
        buf, ev = self._up.get(key, (None, None))
        if ev is not None:
            with stage(span="flrl.wait"):
                ev.synchronize()    # the copy that last read it is done
        if buf is None or buf.numel() < nbytes:
            buf = None
            buf = _pinned_bytes(nbytes)
        self._up[key] = (buf, None)
        return buf

    def upload(self, a: np.ndarray, size: int | None = None,
               slot: int = 0, reserve: int = 0) -> torch.Tensor:
        """u8[size] on the device, ``a``'s bytes first and zeros after,
        ordered before the kernels that the caller launches next.  ``a``
        may be reused by the caller as soon as this returns.  The pinned
        buffer holds at least ``reserve`` bytes, the most that this slot
        takes for a chunk of this size: buffers regrown to each payload's
        size would leave one cached block a size class."""
        a = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        size = a.size if size is None else size
        if not self.cuda:
            t = torch.zeros(size, dtype=torch.uint8)
            t[:a.size] = _host_tensor(a)
            return t
        host = self._pinned((self.turn, slot), max(a.size, reserve))
        with stage("Host copy to pinned memory", a.size,
                   span="flrl.host.stage_in"):
            host.numpy()[:a.size] = a
        with torch.cuda.stream(self.up_stream):
            t = torch.empty(size, dtype=torch.uint8, device=self.device)
            t[:a.size].copy_(host[:a.size], non_blocking=True)
            t[a.size:].zero_()
            ev = torch.cuda.Event()
            ev.record(self.up_stream)
        self._up[(self.turn, slot)] = (host, ev)
        self.compute.wait_event(ev)
        t.record_stream(self.compute)
        return t

    def keep(self, a: np.ndarray) -> np.ndarray:
        """A copy of ``a`` in this chunk's first upload slot, which a
        host-only chunk does not use otherwise, so that such chunks take
        no memory of their own; valid until the walk advances."""
        if not self.cuda:
            return a.copy()
        host = self._pinned((self.turn, 0), a.size).numpy()[:a.size]
        with stage(span="flrl.host.stage_in"):
            host[...] = a
        return host

    def fill(self, n: int, c: int, dest: np.ndarray | None) -> np.ndarray:
        """n bytes of ``c``: in ``dest`` where it is given, else in the
        download buffer (valid until the next download or fill)."""
        if dest is None:
            if not self.cuda:
                return np.full(n, c, np.uint8)
            if self._down is None or self._down.numel() < n:
                self._down = None
                self._down = _pinned_bytes(n)
            dest = self._down[:n].numpy()
        with stage(span="flrl.host.out"):
            dest[...] = c
        return dest

    def to_host_async(self, t: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of the small tensor ``t``, complete once the
        next :meth:`fence` has passed."""
        if not self.cuda:
            return t
        with stage(span="flrl.d2h.pinned"):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
        return h

    def fence(self):
        """An event after everything launched so far (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self.compute)
        return ev

    @staticmethod
    def wait(ev) -> None:
        if ev is not None:
            with stage(span="flrl.wait"):
                ev.synchronize()

    def download(self, t: torch.Tensor, after, dest: np.ndarray | None = None,
                 reserve: int = 0) -> np.ndarray:
        """``t``'s bytes on the host, once the event ``after`` (the
        chunk's :meth:`fence`) has passed: copied into ``dest`` where it is
        given, else into a pinned buffer (of at least ``reserve`` bytes,
        as :meth:`upload`'s) whose view is valid until the next download.
        It waits for that chunk's kernels alone, not for the next chunk's,
        already queued behind its own copy up."""
        t = t.reshape(-1).view(torch.uint8)
        if not self.cuda:
            if dest is None:
                return t.numpy()
            dest[...] = t.numpy()
            return dest
        if dest is None:
            if self._down is None or self._down.numel() < t.numel():
                self._down = None
                self._down = _pinned_bytes(max(t.numel(), reserve))
            host = self._down[:t.numel()]
        else:
            host = _host_tensor(dest)
        self.down_stream.wait_event(after)
        with torch.cuda.stream(self.down_stream):
            host.copy_(t, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.down_stream)
        self.wait(ev)
        return host.numpy() if dest is None else dest


class _Chunk:
    """One submitted chunk, waiting for its drain."""

    def __init__(self, n: int, **fields):
        self.n = n
        self.ready = None           # the host result, where no device ran
        self.fill = None            # the byte of a constant decode
        self.__dict__.update(fields)


def _pipeline(items, submit, drain, depth: int):
    """Submit each item, and drain each entry ``depth`` - 1 submits later
    (at once at depth 1), in order."""
    if depth < 1:
        raise ValueError(f"depth must be at least 1, got {depth}")
    pending = deque()
    for item in items:
        pending.append(submit(item))
        if len(pending) >= depth:
            yield drain(pending.popleft())
    while pending:
        yield drain(pending.popleft())


def encode(data, frame_length: int = FRAME_LENGTH, *,
           device: str | torch.device):
    """u8 bytes → ``(bits u8[F], values u8[V])``, byte-identical to
    ``fl_numpy.encode`` and to the reference binary's containers."""
    kern.check_frame_length(frame_length)
    data = np.asarray(data, np.uint8).reshape(-1)
    return encode_walk(data, frame_length, device)


def encode_walk(data: np.ndarray, frame_length: int,
                device: str | torch.device, to_host: bool = True):
    """:func:`encode_chunks` over ``data``, which it splits in
    frame-aligned chunks of at most ``_device_cap(L)`` bytes.  Returns
    ``(bits, values)`` as NumPy arrays, or with ``to_host=False`` as u8
    tensors on ``device``."""
    n = data.size
    parts = encode_chunks([data], frame_length, device=device,
                          to_host=to_host)
    if not to_host:
        bits, values = zip(*parts)
        if len(bits) == 1:
            return bits[0], values[0]
        return torch.cat(bits), torch.cat(values)
    if n <= _device_cap(frame_length):
        return next(parts)          # one chunk: its arrays as they are
    with stage(span="flrl.host.out"):
        values = np.empty(n, np.uint8)
    bits, pos = [], 0
    for b, v in parts:              # v is valid until the walk advances
        bits.append(b)
        with stage(span="flrl.host.join"):
            values[pos:pos + v.size] = v
        pos += v.size
    with stage(span="flrl.host.join"):
        return np.concatenate(bits), values[:pos]


def encode_chunks(chunks, frame_length: int = FRAME_LENGTH, *,
                  device: str | torch.device, depth: int = 2,
                  to_host: bool = True):
    """The FL encode walk, pipelined: yields ``(bits, values)`` for each u8
    chunk of ``chunks``, in order, byte-identical to :func:`encode` of
    their concatenation (every chunk but the last must be frame-aligned;
    one above ``_device_cap(L)`` is split, with a pair for each piece).
    ``values`` is valid until the generator advances; ``bits`` is the
    caller's.  With ``to_host=False`` both are u8 tensors on ``device``.

    Each chunk is *submitted* (the host closed form of a constant chunk,
    else copied up through a pinned buffer and its kernels launched on the
    route ``FLRL_NO_DENSE`` selects, with no wait on the device) and
    *drained* ``depth`` - 1 chunks later (the uniform flag or the pack-2
    miss judged, a miss re-run on the device words kept for it, the
    payload's size taken from the widths on the host, exactly that many
    bytes copied down, and the field route's host fold), so that a chunk's
    drain overlaps the next one's copy up and kernels.  The JAX package's
    ``fl_jax.encode_chunks`` does the same at depth 2."""
    kern.check_frame_length(frame_length)
    L = frame_length
    lanes = _Lanes(torch.device(device), depth)
    dense = _use_dense()

    def submit(data):
        n = data.size
        if n == 0:
            return _Chunk(0, ready=(np.zeros(0, np.uint8),
                                    np.zeros(0, np.uint8)))
        with stage(span="flrl.host.probe"):
            c = constant_byte_probe(data)
        if c is not None:
            with stage("Compression", n, span="flrl.host.out"):
                return _Chunk(n, ready=_constant_container(c, n, L))
        chunk = (_submit_dense if dense else _submit_fields)(lanes, data, L)
        lanes.next_chunk()
        return chunk

    def drain(chunk):
        if chunk.ready is not None:
            bits, values = chunk.ready
        elif dense:
            return _drain_dense(lanes, chunk, L, to_host)
        else:
            bits, values = _drain_fields(lanes, chunk, L)
        if to_host:
            return bits, values
        return _to_device(bits, lanes.device), _to_device(values,
                                                          lanes.device)

    yield from _pipeline(_aligned_chunks(chunks, L), submit, drain, depth)


def _aligned_chunks(chunks, frame_length: int):
    """``chunks`` as u8 arrays, those above the device cap split
    frame-aligned; a non-frame-aligned chunk that is not the last one is
    rejected, since it would change the container."""
    cap = _device_cap(frame_length)
    ragged = False
    for data in chunks:
        data = np.asarray(data, np.uint8).reshape(-1)
        if ragged:
            raise ValueError("encode_chunks: a non-frame-aligned chunk must "
                             "be the last one")
        ragged = data.size % frame_length != 0
        for off in range(0, max(data.size, 1), cap):
            yield data[off:off + cap]


def _submit_dense(lanes: _Lanes, data: np.ndarray, L: int) -> _Chunk:
    """The dense route's submit: widths (with the uniform flag where the
    host probe sees a uniform first tile) and the pack, the uniform one
    speculatively, the input kept for a miss."""
    n = data.size
    with stage(span="flrl.host.probe"):
        fb = kern.host_probe_uniform_b(data, L) or 0
    with stage("Copy input data to device", n, span="flrl.h2d.pinned",
               on=lanes.up_stream):
        x = lanes.upload(data)
    with stage("Compression", n, span="flrl.kernels", on=lanes.compute):
        bits_d, flag = kern.frame_widths(x, L, fb_expect=fb)
        if fb:
            values_d = kern.pack(x, L, fb=fb)
        else:
            offs = kern.frame_offsets(bits_d, n, L)
            values_d = kern.pack(x, L, bits=bits_d, offs=offs, size=n)
    return _Chunk(n, x=x if fb else None, bits_d=bits_d, values_d=values_d,
                  bits_h=lanes.to_host_async(bits_d),
                  flag_h=lanes.to_host_async(flag) if fb else None,
                  done=lanes.fence())


def _drain_dense(lanes: _Lanes, chunk: _Chunk, L: int, to_host: bool):
    n = chunk.n
    lanes.wait(chunk.done)
    values_d, done = chunk.values_d, chunk.done
    if chunk.flag_h is not None and int(chunk.flag_h.numpy()[0]) != 0:
        # the uniform speculation missed: the general pack of the kept input
        with stage("Compression", n, span="flrl.kernels", on=lanes.compute):
            offs = kern.frame_offsets(chunk.bits_d, n, L)
            values_d = kern.pack(chunk.x, L, bits=chunk.bits_d, offs=offs,
                                 size=n)
        done = lanes.fence()
    with stage(span="flrl.host.layout"):
        bits = chunk.bits_h.numpy().copy()
        values_d = values_d[:payload_size(bits, n, L)]
    if not to_host:
        return chunk.bits_d, values_d
    with stage("Copy results to CPU", values_d.numel(),
               span="flrl.d2h.pinned"):
        return bits, lanes.download(values_d, done, reserve=n)


def _submit_fields(lanes: _Lanes, data: np.ndarray, L: int) -> _Chunk:
    """The field route's submit: the pack-2 field encode where the layout
    allows (the words kept for a miss), else the base one."""
    n = data.size
    wpf = L // 4
    frames = -(-n // L)
    pack = _use_pack2(L)
    # the field encoders carry no tail mask: the pad must be zero
    unit = PACK_TILE_R * fkern.LANES * 4 if pack else L
    with stage("Copy input data to device", n, span="flrl.h2d.pinned",
               on=lanes.up_stream):
        buf = lanes.upload(data, -(-n // unit) * unit)
    words = buf.view(torch.int32)
    with stage("Compression", n, span="flrl.kernels", on=lanes.compute):
        if pack:
            bits_d, fields_d = encode_fields_device(words, L, pack=True)
        else:
            bits_d, fields_d = encode_fields_device(words[:frames * wpf], L)
    return _Chunk(n, pack=pack, words=words if pack else None,
                  fields_d=fields_d, bits_h=lanes.to_host_async(
                      bits_d[:frames]), done=lanes.fence())


def _drain_fields(lanes: _Lanes, chunk: _Chunk, L: int):
    n = chunk.n
    wpf = L // 4
    frames = -(-n // L)
    lanes.wait(chunk.done)
    with stage(span="flrl.host.layout"):
        bits = chunk.bits_h.numpy().copy()
    if chunk.pack:
        if int(bits.max()) <= 4:
            need = fkern.packed_words(frames * wpf, PACK_TILE_R)
            with stage("Copy results to CPU", need * 4,
                       span="flrl.d2h.pinned"):
                packed = lanes.download(chunk.fields_d[:need], chunk.done,
                                        reserve=frames * L)
            with stage("Host fold (ragged placement)", n,
                       span="flrl.host.fold"):
                return bits, fold_p2(packed.view(np.uint32), bits, n, L,
                                     PACK_TILE_R)
        # the pack-2 speculation missed (a width > 4): the base encode of
        # the words kept on the device
        with stage("Compression", n, span="flrl.kernels", on=lanes.compute):
            _, fields_d = encode_fields_device(chunk.words[:frames * wpf], L)
        done = lanes.fence()
    else:
        fields_d, done = chunk.fields_d, chunk.done
    with stage("Copy results to CPU", frames * wpf * 4,
               span="flrl.d2h.pinned"):
        fields_h = lanes.download(fields_d, done, reserve=frames * L)
    with stage("Host fold (ragged placement)", n, span="flrl.host.fold"):
        return bits, fold(fields_h.view(np.uint32), bits, n, L)


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
    widths, voffs = container_layout(n, bits, values.size, frame_length)
    return decode_walk(n, widths, values, voffs, frame_length, device)


def _closed_form(n: int, bits: np.ndarray, values: np.ndarray,
                 frame_length: int):
    """Which host closed form decodes the container: ``("constant", c)``,
    ``("identity", None)`` (all-8 widths: the payload is the output) or
    None.  Raises when the widths array is shorter than the frame
    count."""
    frames = -(-n // frame_length)
    if bits.size < frames:
        raise ValueError(
            "fl decode: corrupt container (bits array shorter than "
            f"frame count: {bits.size} < {frames})")
    with stage(span="flrl.host.probe"):
        c = host_constant_decode_probe(bits, values, n, frame_length)
        if c is not None:
            return "constant", c
        if _all_eight(bits, values, n, frame_length):
            return "identity", None
        return None


def decode_closed_form(n: int, bits: np.ndarray, values: np.ndarray,
                       frame_length: int) -> np.ndarray | None:
    """The host closed forms of decode, tried before any device work: the
    constant container becomes a memset, all-8 widths mean the payload is
    the output.  Returns the n decoded bytes, or None.  Raises when the
    widths array is shorter than the frame count."""
    closed = _closed_form(n, bits, values, frame_length)
    if closed is None:
        return None
    with stage("Decompression", n, span="flrl.host.out"):
        if closed[0] == "constant":
            return np.full(n, closed[1], np.uint8)
        return values[:n].copy()


def check_widths(n: int, bits: np.ndarray, values_size: int,
                 frame_length: int) -> np.ndarray:
    """The widths u8[F] of the frames of an n-byte stream (n > 0), with no
    array as large as they are made.  Raises on a width byte outside 1..8
    or a payload of ``values_size`` bytes, shorter than the widths imply
    (the caller has checked that ``bits`` holds F widths)."""
    widths = bits[:-(-n // frame_length)]
    lo, hi = int(widths.min()), int(widths.max())
    if lo < 1 or hi > 8:
        raise ValueError(
            "fl decode: corrupt container (width byte outside 1..8: "
            f"{lo if lo < 1 else hi})")
    need = payload_size(widths, n, frame_length)
    if values_size < need:
        raise ValueError(
            "fl decode: corrupt container (payload shorter than the "
            f"widths imply: {values_size} < {need})")
    return widths


def container_layout(n: int, bits: np.ndarray, values_size: int,
                     frame_length: int):
    """``(widths u8[F], voffs i64[F+1])``: the checked widths
    (:func:`check_widths`) and the exclusive scan of their payload
    bytes."""
    with stage(span="flrl.host.layout"):
        widths = check_widths(n, bits, values_size, frame_length)
        counts = np.minimum(
            n - np.arange(widths.size, dtype=np.int64) * frame_length,
            frame_length)
        voffs = np.zeros(widths.size + 1, np.int64)
        np.cumsum((widths.astype(np.int64) * counts + 7) // 8,
                  out=voffs[1:])
        return widths, voffs


def decode_walk(n: int, widths: np.ndarray, values: np.ndarray,
                voffs: np.ndarray, frame_length: int,
                device: str | torch.device,
                out: np.ndarray | None = None) -> np.ndarray:
    """:func:`decode_chunks` over the n bytes of the frames ``widths``
    (each 1..8) whose payload starts at ``values[voffs[f]]``, in chunks of
    at most ``_device_cap(L)`` bytes, each copied straight into the
    output: ``out`` (u8[n]) where it is given, else a new array."""
    if out is None:
        with stage(span="flrl.host.out"):
            out = np.empty(n, np.uint8)
    elif out.shape != (n,) or out.dtype != np.uint8:
        raise ValueError(f"decode_walk: out must be u8[{n}], got "
                         f"{out.dtype}{list(out.shape)}")
    cap = _device_cap(frame_length)
    fpc = cap // frame_length

    def parts():
        for off in range(0, n, cap):
            f0 = off // frame_length
            f1 = min(f0 + fpc, widths.size)
            yield (min(cap, n - off), widths[f0:f1],
                   values[voffs[f0]:voffs[f1]])

    for _ in decode_chunks(parts(), frame_length, device=device, out=out):
        pass
    return out


def decode_chunks(parts, frame_length: int = FRAME_LENGTH, *,
                  device: str | torch.device, depth: int = 2,
                  out: np.ndarray | None = None):
    """The FL decode walk, pipelined: for each ``(n, widths, values)`` of
    ``parts`` (an n-byte frame-aligned piece of the stream, its widths,
    each 1..8, and exactly its payload; one above ``_device_cap(L)`` is
    split), yields its n decoded bytes, in order.  With ``out`` they are
    copied into ``out`` one part after another and the yielded array is
    that slice of it; else it is valid until the generator advances.

    Each part is *submitted* (the host closed forms of a constant or
    all-8 part, else its payload, and on the general path its widths,
    copied up through pinned buffers and its kernels launched on the route
    ``FLRL_NO_DENSE`` selects, the field route's host unfold first) and
    *drained* ``depth`` - 1 parts later (its bytes copied down)."""
    kern.check_frame_length(frame_length)
    L = frame_length
    lanes = _Lanes(torch.device(device), depth)
    dense = _use_dense()
    pos = 0

    def submit(part):
        n, bits, values = part
        if n == 0:
            return _Chunk(0, ready=np.zeros(0, np.uint8))
        closed = _closed_form(n, bits, values, L)
        if closed is None:
            chunk = (_submit_decode if dense else _submit_decode_fields)(
                lanes, n, bits[:-(-n // L)], values, L)
        elif closed[0] == "constant":
            chunk = _Chunk(n, fill=closed[1])   # filled at drain
        else:
            # ``values`` may be the caller's reused buffer: keep its bytes
            with stage("Decompression", n, span="flrl.host.out"):
                chunk = _Chunk(n, ready=lanes.keep(values[:n]))
        lanes.next_chunk()
        return chunk

    def drain(chunk):
        nonlocal pos
        dest = None if out is None else out[pos:pos + chunk.n]
        pos += chunk.n
        if chunk.fill is not None:
            with stage("Decompression", chunk.n, span="flrl.host.out"):
                return lanes.fill(chunk.n, chunk.fill, dest)
        if chunk.ready is not None:
            if dest is None:
                return chunk.ready
            with stage(span="flrl.host.out"):
                dest[...] = chunk.ready
            return dest
        with stage("Copy results to CPU", chunk.n,
                   span="flrl.d2h.pinned" if dest is None
                   else "flrl.d2h.pageable"):
            return lanes.download(chunk.out_d, chunk.done, dest)

    yield from _pipeline(_capped_parts(parts, L), submit, drain, depth)


def _capped_parts(parts, frame_length: int):
    """``parts`` with those above the device cap split frame-aligned by
    their widths."""
    cap = _device_cap(frame_length)
    fpc = cap // frame_length
    for n, bits, values in parts:
        n = int(n)
        bits = np.asarray(bits, np.uint8).reshape(-1)
        values = np.asarray(values, np.uint8).reshape(-1)
        if n <= cap:
            yield n, bits, values
            continue
        frames = -(-n // frame_length)
        _, voffs = container_layout(n, bits, values.size, frame_length)
        for off in range(0, n, cap):
            f0 = off // frame_length
            f1 = min(f0 + fpc, frames)
            yield (min(cap, n - off), bits[f0:f1],
                   values[voffs[f0]:voffs[f1]])


def _check_part(n: int, bits: np.ndarray, values: np.ndarray,
                L: int) -> tuple[int, int]:
    """The part's least and greatest width; raises where a width lies
    outside 1..8 or the payload is not the size the widths imply, which
    the kernels would read past."""
    with stage(span="flrl.host.layout"):
        lo, hi = int(bits.min()), int(bits.max())
        size = payload_size(bits, n, L)
    if lo < 1 or hi > 8 or values.size != size:
        raise ValueError("fl decode: corrupt part (widths outside 1..8 or "
                         "a payload of another size than they imply)")
    return lo, hi


def _submit_decode(lanes: _Lanes, n: int, bits: np.ndarray,
                   values: np.ndarray, L: int) -> _Chunk:
    """The dense route's submit: uniform mode where every width of the
    part is one, else the offsets scan and the general unpack."""
    lo, hi = _check_part(n, bits, values, L)
    fb = lo if lo == hi else 0
    with stage("Copy input to device", values.size + bits.size,
               span="flrl.h2d.pinned", on=lanes.up_stream):
        # a part's payload is at most its n bytes
        v = lanes.upload(values, reserve=n)
        b = None if fb else lanes.upload(bits, slot=1)
    with stage("Decompression", n, span="flrl.kernels", on=lanes.compute):
        if fb:
            out_d = kern.unpack(v, n, L, fb=fb)
        else:
            offs = kern.frame_offsets(b, n, L)
            out_d = kern.unpack(v, n, L, bits=b, offs=offs)
    return _Chunk(n, out_d=out_d, done=lanes.fence())


def _submit_decode_fields(lanes: _Lanes, n: int, bits: np.ndarray,
                          values: np.ndarray, L: int) -> _Chunk:
    """The field route's submit: the host unfolds the payload into fields
    (the pack-2 layout where the layout allows and every width of the part
    is ≤ 4), while the device still works on the part before; the device
    decodes them."""
    _, hi = _check_part(n, bits, values, L)
    nw = bits.size * (L // 4)
    pack = _use_pack2(L) and hi <= 4
    with stage("Host unfold (ragged placement)", n, span="flrl.host.unfold"):
        if pack:
            fields_h = unfold_p2(values, bits, n, L, PACK_TILE_R,
                                 fkern.packed_words(nw, PACK_TILE_R))
        else:
            fields_h = unfold(values, bits, n, L)
    with stage("Copy input to device", fields_h.nbytes + bits.size,
               span="flrl.h2d.pinned", on=lanes.up_stream):
        f = lanes.upload(fields_h, reserve=bits.size * L).view(torch.int32)
        b = lanes.upload(bits, slot=1)
    with stage("Decompression", n, span="flrl.kernels", on=lanes.compute):
        out_d = decode_fields_device(f, b, L, pack=pack)
    return _Chunk(n, out_d=out_d.view(torch.uint8)[:n], done=lanes.fence())
