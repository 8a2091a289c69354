"""Dense FL kernels on the GPU, each beside its plain PyTorch version.

Counterpart of ``fl_rl_compression_mpi_tpu/ops/fl_dense_pallas.py``.  The
kernels live in ``csrc/fl_dense.cu``; their wrappers here are

=================  ===================================================
``frame_widths``   per-frame width; in uniform mode also a mismatch flag
``frame_offsets``  exclusive scan of per-frame payload bytes
``pack``           bytes → container payload (general or uniform mode)
``unpack``         container payload → bytes (general or uniform mode)
=================  ===================================================

A wrapper given CPU tensors returns its plain PyTorch version
(``*_ref``); given CUDA tensors it launches its kernel on the current
stream or raises.  It never falls back from one to the other.  Each
launch adds one to ``LAUNCHES[<kernel>]`` (uniform-mode pack and unpack
count under their own ``*_uniform`` keys), so a run can show which
kernels it went through, and to its card's and its mesh shard's counts
(:func:`launches_by`), so that a run over several cards can show that
each of them went through its path.

The plain versions work on uint8/int64 tensors only: on the CPU,
``torch.uint32`` has no shifts, ``max`` or comparisons.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..utils.timers import current_card
from .bitpack import FRAME_LENGTH

# Bytes the host probes for the speculative uniform mode: the first tile
# of the TPU's single-width kernels (1024 rows of 512 bytes).
DENSE_UNIFORM_TILE_R = 1024

# The most bytes one widths, pack or unpack launch takes (kDenseMaxBytes in
# csrc/fl_dense.cuh; the field kernels take as many bytes of words).
MAX_BYTES = 1 << 31

# Frames one block of ``flrl_frame_offsets`` scans (kOffsetsTile in
# csrc/fl_dense.cuh): the kernel's scratch holds a status word a tile and
# a ticket.
OFFSETS_TILE = 4096

LAUNCHES = {"fl_frame_widths": 0, "fl_frame_offsets": 0,
            "fl_pack": 0, "fl_pack_uniform": 0,
            "fl_unpack": 0, "fl_unpack_uniform": 0}

# Every kernel module's launches by ("device", card index) and by ("shard",
# mesh shard or None) -> {kernel: count}.  A mesh's per-card threads launch
# at once, so every count changes under the lock.
_BY: dict = {}
_COUNT_LOCK = threading.Lock()


def count_launch(table: dict, name: str, device: torch.device) -> None:
    """One launch of the kernel ``name`` (a key of the module's
    ``table``) on ``device``, from this thread."""
    with _COUNT_LOCK:
        table[name] += 1
        for key in (("device", device.index), ("shard", current_card())):
            per = _BY.setdefault(key, {})
            per[name] = per.get(name, 0) + 1


def reset_table(table: dict) -> None:
    """Set the module's ``table`` and its kernels' counts by card and by
    shard to 0."""
    with _COUNT_LOCK:
        for k in table:
            table[k] = 0
        for per in _BY.values():
            for k in table:
                per.pop(k, None)


def launches_by(what: str) -> dict:
    """``{card index: {kernel: count}}`` for ``what`` = "device", or
    ``{shard: {...}}`` for "shard" (the shard of a mesh whose per-card
    thread launched; None outside a mesh's threads), over every kernel
    module, since each module's counts were last reset."""
    with _COUNT_LOCK:
        return {key[1]: {k: v for k, v in per.items() if v}
                for key, per in _BY.items() if key[0] == what}


def reset_launches() -> None:
    reset_table(LAUNCHES)


def host_probe_uniform_b(data: np.ndarray, frame_length: int = FRAME_LENGTH,
                         tile_r: int | None = None) -> int | None:
    """Width probe for the speculative uniform mode: returns fb in 1..8
    when every frame of the first tile (``tile_r``·512 bytes) has width
    fb, else None.  The device's widths flag stays authoritative for the
    rest of the stream.  Unlike the TPU probe, any width qualifies: the
    GPU kernels need no per-width routing masks."""
    R = DENSE_UNIFORM_TILE_R if tile_r is None else tile_r
    probe = R * 512 // frame_length * frame_length
    if R % 8 != 0 or probe == 0 or data.size < R * 512:
        return None
    fmax = np.asarray(data[:probe], np.uint8).reshape(-1, frame_length).max(1)
    b = np.maximum(np.frexp(fmax.astype(np.float64))[1], 1)
    fb = int(b[0])
    return fb if bool((b == fb).all()) else None


# ---------------------------------------------------------------------------
# Plain PyTorch versions.
# ---------------------------------------------------------------------------

def _frames(n: int, frame_length: int) -> int:
    return -(-n // frame_length)


def _counts(n: int, frame_length: int, device) -> torch.Tensor:
    F = _frames(n, frame_length)
    f = torch.arange(F, dtype=torch.int64, device=device)
    return (n - f * frame_length).clamp(max=frame_length)


def _uniform_bytes(n: int, frame_length: int, fb: int) -> int:
    """Payload size of an n-byte stream whose frames all have width fb."""
    F = _frames(n, frame_length)
    tail = n - (F - 1) * frame_length
    return (F - 1) * frame_length * fb // 8 + -(-tail * fb // 8)


def _padded_frames(data: torch.Tensor, frame_length: int) -> torch.Tensor:
    n = data.numel()
    F = _frames(n, frame_length)
    buf = torch.zeros(F * frame_length, dtype=torch.uint8, device=data.device)
    buf[:n] = data
    return buf.view(F, frame_length)


def frame_widths_ref(data: torch.Tensor, frame_length: int = FRAME_LENGTH,
                     fb_expect: int = 0):
    """``(bits u8[F], flag i32[1])``: width max(1, bitlen(max byte)) per
    frame; flag is 1 when fb_expect != 0 and some frame differs."""
    fmax = _padded_frames(data, frame_length).amax(dim=1)
    bits = torch.ones_like(fmax)
    for k in range(1, 8):
        bits += (fmax >= (1 << k)).to(torch.uint8)
    flag = torch.zeros(1, dtype=torch.int32, device=data.device)
    if fb_expect:
        flag[0] = (bits != fb_expect).any().to(torch.int32)
    return bits, flag


def frame_offsets_ref(bits: torch.Tensor, n: int,
                      frame_length: int = FRAME_LENGTH) -> torch.Tensor:
    """``offs i64[F+1]``: exclusive scan of ceil(count·b/8) per frame;
    ``offs[F]`` is the payload size."""
    fbytes = (bits.to(torch.int64) * _counts(n, frame_length, bits.device)
              + 7) // 8
    offs = torch.zeros(bits.numel() + 1, dtype=torch.int64,
                       device=bits.device)
    torch.cumsum(fbytes, 0, out=offs[1:])
    return offs


def _layout(n, frame_length, bits, offs, fb, device):
    """Per-frame widths and payload offsets of either mode."""
    F = _frames(n, frame_length)
    if fb:
        widths = torch.full((F,), fb, dtype=torch.int64, device=device)
        offs = torch.arange(F + 1, dtype=torch.int64, device=device) * (
            frame_length * fb // 8)
        offs[F] = _uniform_bytes(n, frame_length, fb)
        return widths, offs
    return bits.to(torch.int64), offs


def pack_ref(data: torch.Tensor, frame_length: int = FRAME_LENGTH,
             bits: torch.Tensor | None = None,
             offs: torch.Tensor | None = None, fb: int = 0) -> torch.Tensor:
    """Container payload of ``data``: frames packed LSB-first at their
    widths, back to back.  Eight values at width b are exactly b bytes,
    so each group of 8 is one integer split into b bytes."""
    n = data.numel()
    L = frame_length
    widths, offs = _layout(n, L, bits, offs, fb, data.device)
    fbytes = (widths * _counts(n, L, data.device) + 7) // 8
    values = torch.zeros(int(offs[-1]), dtype=torch.uint8, device=data.device)
    groups = _padded_frames(data, L).view(-1, L // 8, 8)
    for b in range(1, 9):
        sel = (widths == b).nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        if b == 8:
            packed = groups[sel].reshape(sel.numel(), L)
        else:
            g = groups[sel].to(torch.int64) & ((1 << b) - 1)
            shift = torch.arange(8, device=data.device) * b
            word = (g << shift).sum(-1, keepdim=True)       # < 2^56
            byte_shift = torch.arange(b, device=data.device) * 8
            packed = ((word >> byte_shift) & 0xFF).to(torch.uint8)
            packed = packed.reshape(sel.numel(), L * b // 8)
        pos = torch.arange(L * b // 8, device=data.device)
        keep = pos < fbytes[sel].unsqueeze(1)
        values[(offs[sel].unsqueeze(1) + pos)[keep]] = packed[keep]
    return values


def unpack_ref(values: torch.Tensor, n: int,
               frame_length: int = FRAME_LENGTH,
               bits: torch.Tensor | None = None,
               offs: torch.Tensor | None = None,
               fb: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_ref`: payload → n bytes."""
    L = frame_length
    widths, offs = _layout(n, L, bits, offs, fb, values.device)
    F = _frames(n, L)
    out = torch.zeros(F, L, dtype=torch.uint8, device=values.device)
    # reads past the payload's end fall on zeros; they only feed values
    # beyond n, which are cut off below
    vpad = torch.cat([values, torch.zeros(L + 8, dtype=torch.uint8,
                                          device=values.device)])
    for b in range(1, 9):
        sel = (widths == b).nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        pos = torch.arange(L * b // 8, device=values.device)
        payload = vpad[offs[sel].unsqueeze(1) + pos]
        if b == 8:
            out[sel] = payload
            continue
        byts = payload.view(sel.numel(), L // 8, b).to(torch.int64)
        byte_shift = torch.arange(b, device=values.device) * 8
        word = (byts << byte_shift).sum(-1, keepdim=True)   # < 2^56
        shift = torch.arange(8, device=values.device) * b
        vals = (word >> shift) & ((1 << b) - 1)
        out[sel] = vals.to(torch.uint8).reshape(sel.numel(), L)
    return out.view(-1)[:n]


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def check_frame_length(frame_length: int) -> None:
    if frame_length <= 0 or frame_length % 8:
        raise ValueError(
            f"frame_length must be a positive multiple of 8, got "
            f"{frame_length}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           numel: int | None = None) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: expected {numel} elements, got "
                         f"{t.numel()}")


def _on_cuda(first: torch.Tensor, *others: torch.Tensor | None) -> bool:
    """False for CPU tensors (plain version), True for CUDA tensors on one
    device (kernel); raises on anything else."""
    devices = {t.device for t in (first, *others) if t is not None}
    if len(devices) != 1:
        raise ValueError("tensors on different devices: "
                         f"{sorted(map(str, devices))}")
    if first.device.type == "cpu":
        return False
    if first.device.type != "cuda":
        raise ValueError(f"no kernel for device {first.device}")
    return True


def _aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a 16-byte aligned buffer")


def _launch(name: str, *args) -> None:
    from . import _build
    fn = getattr(_build.lib(), name)
    if torch.autograd._profiler_enabled():
        # a range named after the entry point, which a --profile trace
        # shows; entering one costs more host time than the launch, so
        # only under a profiler
        with torch.profiler.record_function(name):
            rc = fn(*args)
    else:
        rc = fn(*args)
    if rc != 0:
        msg = _build.lib().flrl_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def frame_widths(data: torch.Tensor, frame_length: int = FRAME_LENGTH,
                 fb_expect: int = 0):
    """``(bits u8[F], flag i32[1])`` of ``data`` u8[n]; see
    :func:`frame_widths_ref`.  The kernel takes at most 2^31 bytes a
    call."""
    check_frame_length(frame_length)
    _check(data, "data", torch.uint8)
    if not 0 <= fb_expect <= 8:
        raise ValueError(f"fb_expect must be in 0..8, got {fb_expect}")
    if not _on_cuda(data):
        return frame_widths_ref(data, frame_length, fb_expect)
    _aligned(data, "data")
    n = data.numel()
    bits = torch.empty(_frames(n, frame_length), dtype=torch.uint8,
                       device=data.device)
    flag = torch.zeros(1, dtype=torch.int32, device=data.device)
    _launch("flrl_frame_widths", data.data_ptr(), n, frame_length, fb_expect,
            bits.data_ptr(), flag.data_ptr(), data.device.index,
            _stream(data))
    count_launch(LAUNCHES, "fl_frame_widths", data.device)
    return bits, flag


def frame_offsets(bits: torch.Tensor, n: int,
                  frame_length: int = FRAME_LENGTH) -> torch.Tensor:
    """``offs i64[F+1]`` of the widths ``bits`` u8[F]; see
    :func:`frame_offsets_ref`."""
    check_frame_length(frame_length)
    F = _frames(n, frame_length)
    _check(bits, "bits", torch.uint8, F)
    if not _on_cuda(bits):
        return frame_offsets_ref(bits, n, frame_length)
    # one allocation: the offsets, then the scan's status words and ticket
    # (the launcher clears those on the stream)
    buf = torch.empty(F + 1 + -(-F // OFFSETS_TILE) + 1, dtype=torch.int64,
                      device=bits.device)
    _launch("flrl_frame_offsets", bits.data_ptr(), n, frame_length,
            buf.data_ptr(), buf.data_ptr() + 8 * (F + 1), bits.device.index,
            _stream(bits))
    count_launch(LAUNCHES, "fl_frame_offsets", bits.device)
    return buf[:F + 1]


def _check_mode(n, frame_length, bits, offs, fb) -> None:
    F = _frames(n, frame_length)
    if fb:
        if not 1 <= fb <= 8 or bits is not None or offs is not None:
            raise ValueError("uniform mode takes fb in 1..8 and no "
                             "bits/offs")
    else:
        if bits is None or offs is None:
            raise ValueError("general mode takes bits and offs")
        _check(bits, "bits", torch.uint8, F)
        _check(offs, "offs", torch.int64, F + 1)


def pack(data: torch.Tensor, frame_length: int = FRAME_LENGTH,
         bits: torch.Tensor | None = None, offs: torch.Tensor | None = None,
         fb: int = 0, size: int | None = None) -> torch.Tensor:
    """Container payload u8[V] of ``data`` u8[n].  General mode: the
    frames' ``bits`` and ``offs``.  Uniform mode: ``fb`` alone, every
    frame at width fb (a frame of another width yields junk — check the
    widths flag first).  The kernel takes at most 2^31 bytes a call.

    ``size`` (general mode, at least n): return u8[size] whose first V
    bytes are the payload, the rest unspecified, so that nothing is read
    back from the device.  V ≤ n, since no frame packs to more bytes than
    it holds.  Without it the wrapper reads ``offs[-1]`` back, which waits
    for the device."""
    check_frame_length(frame_length)
    _check(data, "data", torch.uint8)
    n = data.numel()
    _check_mode(n, frame_length, bits, offs, fb)
    if size is not None and (fb or size < n):
        raise ValueError(f"size is for general mode and at least n = {n}, "
                         f"got {size}")
    if not _on_cuda(data, bits, offs):
        values = pack_ref(data, frame_length, bits, offs, fb)
        if size is None:
            return values
        out = torch.zeros(size, dtype=torch.uint8, device=data.device)
        out[:values.numel()] = values
        return out
    _aligned(data, "data")
    if size is None:
        size = _uniform_bytes(n, frame_length, fb) if fb else int(offs[-1])
    values = torch.empty(size, dtype=torch.uint8, device=data.device)
    _launch("flrl_pack", data.data_ptr(), n, frame_length,
            None if fb else bits.data_ptr(), None if fb else offs.data_ptr(),
            fb, values.data_ptr(), data.device.index, _stream(data))
    count_launch(LAUNCHES, "fl_pack_uniform" if fb else "fl_pack",
                 data.device)
    return values


def unpack(values: torch.Tensor, n: int, frame_length: int = FRAME_LENGTH,
           bits: torch.Tensor | None = None,
           offs: torch.Tensor | None = None, fb: int = 0) -> torch.Tensor:
    """n decoded bytes u8[n] of the payload ``values``; modes as in
    :func:`pack`.  Reads stop at the payload's end, which may lie at any
    alignment.  The kernel takes at most 2^31 bytes a call."""
    check_frame_length(frame_length)
    _check(values, "values", torch.uint8)
    _check_mode(n, frame_length, bits, offs, fb)
    if not _on_cuda(values, bits, offs):
        return unpack_ref(values, n, frame_length, bits, offs, fb)
    out = torch.empty(n, dtype=torch.uint8, device=values.device)
    _launch("flrl_unpack", values.data_ptr(), values.numel(), n,
            frame_length, None if fb else bits.data_ptr(),
            None if fb else offs.data_ptr(), fb, out.data_ptr(),
            values.device.index, _stream(values))
    count_launch(LAUNCHES, "fl_unpack_uniform" if fb else "fl_unpack",
                 values.device)
    return out
