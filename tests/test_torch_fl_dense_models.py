"""NumPy models of the index math of the dense widths and unpack kernels
(``csrc/fl_dense.cu``), held against their plain PyTorch versions.

A CUDA kernel cannot run here, so each model repeats its kernel's
arithmetic step for step: the lanes' U-byte groups, the warp spans of 32·U
bytes, the frame of a position by multiply-high, the xor-shuffle combine
of the widths, the unpack's payload run, its stage at the run's 16-byte
phase (head, 16-byte body, tail), the five-word stage read and
``unpack8``.  Tolerance: byte equality throughout."""

import os
import re

import numpy as np
import pytest
import torch

from fuzz_battery import battery
from test_torch_fl_dense import TAIL_CASES
from fl_rl_compression_mpi_tpu_torch.ops import fl_dense_cuda as k

WARP = 32
U64 = np.uint64


def _header_constant(name: str) -> int:
    """A constant of csrc/fl_dense.cuh: a sum of products of integers and
    kWarp."""
    path = os.path.join(os.path.dirname(k.__file__), "..", "csrc",
                        "fl_dense.cuh")
    with open(path) as f:
        expr = re.search(rf"constexpr int {name} = ([^;]+);", f.read())
    terms = expr.group(1).replace("kWarp", str(WARP)).split("+")
    return sum(int(np.prod([int(x) for x in t.split("*")])) for t in terms)


SPANS = _header_constant("kWidthsSpans")
STAGE = _header_constant("kUnpackStage")


def _launch_length(n: int, L: int) -> int:
    """The launchers' frame length: any L ≥ n is one frame of n bytes."""
    return L if L < n else -(-n // 16) * 16


def _lane_bytes(L: int) -> int:
    return 16 if L % 16 == 0 else 8


def _umulhi(p: np.ndarray, recip: int) -> np.ndarray:
    """High 64 bits of p·recip for p < 2^32, in uint64 pieces."""
    hi, lo = U64(recip >> 32), U64(recip & 0xFFFFFFFF)
    return (p * hi + ((p * lo) >> U64(32))) >> U64(32)


def _mask(bits):
    """(1 << bits) - 1 for 0 ≤ bits ≤ 64, elementwise."""
    bits = np.asarray(bits, np.uint64)
    full = bits >= 64
    return np.where(full, ~U64(0),
                    (U64(1) << np.where(full, 0, bits).astype(np.uint64))
                    - U64(1))


def _pack8(v, b):
    """fl_dense.cu's pack8: eight bytes, each masked to b bits, packed
    LSB-first into 8·b bits."""
    b = np.asarray(b, np.uint64)
    v = v & (_mask(b) * U64(0x0101010101010101))
    v = (v & U64(0x00FF00FF00FF00FF)) | (
        (v & U64(0xFF00FF00FF00FF00)) >> (U64(8) - b))
    v = (v & U64(0x0000FFFF0000FFFF)) | (
        (v & U64(0xFFFF0000FFFF0000)) >> (U64(16) - U64(2) * b))
    return (v & U64(0xFFFFFFFF)) | ((v >> U64(32)) << (U64(4) * b))


def _unpack8(w, b):
    """fl_dense.cu's unpack8: 8·b bits into eight bytes of b bits."""
    b = np.asarray(b, np.uint64)
    m4 = _mask(U64(4) * b)
    v = (w & m4) | ((w >> (U64(4) * b)) & m4) << U64(32)
    m2 = _mask(U64(2) * b) * U64(0x0000000100000001)
    v = (v & m2) | ((v >> (U64(2) * b)) & m2) << U64(16)
    m1 = _mask(b) * U64(0x0001000100010001)
    return (v & m1) | ((v >> b) & m1) << U64(8)


@pytest.mark.parametrize("b", range(1, 9))
def test_unpack8_inverts_pack8(b):
    g = np.random.default_rng(b)
    v = g.integers(0, 2**64, 20000, dtype=np.uint64)
    packed = _pack8(v, b)
    if b < 8:
        assert int((packed >> U64(8 * b)).max()) == 0   # 8·b bits only
    # pack8 is the LSB-first packing of the container (fl_numpy's order)
    byts = v.view(np.uint8).reshape(-1, 8).astype(np.uint64) & U64(
        (1 << b) - 1)
    want = (byts << (np.arange(8, dtype=np.uint64) * U64(b))).sum(
        1, dtype=np.uint64)
    np.testing.assert_array_equal(packed, want)
    np.testing.assert_array_equal(
        _unpack8(packed, b), v & (U64((1 << b) - 1) * U64(0x0101010101010101)))


# ---------------------------------------------------------------------------
# Widths
# ---------------------------------------------------------------------------

def _model_widths(data: np.ndarray, frame_length: int, fb_expect: int):
    """flrl_frame_widths: (bits, flag) the kernel writes."""
    n = data.size
    if n == 0:                                  # the launcher returns
        return np.zeros(0, np.uint8), 0
    L = _launch_length(n, frame_length)
    U = _lane_bytes(L)
    span = WARP * U
    frames = -(-n // L)
    bits = np.zeros(frames, np.uint8)
    if span % L == 0:
        kk = (L // U).bit_length() - 1
        per_span = WARP >> kk
        per_step = SPANS * per_span
        step = SPANS * span
        steps = -(-n // step)
        buf = np.zeros(steps * step, np.uint8)      # zeros past n
        buf[:n] = data
        lanes = np.bitwise_or.reduce(buf.reshape(steps, SPANS, WARP, U), 3)
        m = np.zeros((steps, WARP), np.uint32)      # byte j: span j
        for j in range(SPANS):
            m |= lanes[:, j, :].astype(np.uint32) << (8 * j)
        lane = np.arange(WARP)
        for i in range(kk):
            m = m | m[:, lane ^ (1 << i)]
        first = lane[(lane & ((1 << kk) - 1)) == 0]
        for s in range(steps):
            f0 = s * per_step
            assert f0 % min(per_step, 16) == 0      # aligned vector stores
            for j in range(SPANS):
                g = j * per_span + (first >> kk)
                keep = f0 + g < frames
                b = (m[s, first[keep]] >> (8 * j)) & 0xFF
                bits[f0 + g[keep]] = np.maximum(
                    1, np.frexp(b.astype(np.float64))[1])
    else:                                       # a warp a frame
        trips = -(-L // span)                   # a lane's U-byte groups
        buf = np.zeros(frames * L, np.uint8)
        buf[:n] = data
        frame = np.zeros((frames, trips * span), np.uint8)
        frame[:, :L] = buf.reshape(frames, L)
        lanes = np.bitwise_or.reduce(
            frame.reshape(frames, trips, WARP, U), axis=(1, 3))
        m = np.bitwise_or.reduce(lanes, 1)      # __reduce_or_sync
        bits[:] = np.maximum(1, np.frexp(m.astype(np.float64))[1])
    flag = int(bool(fb_expect) and bool((bits != fb_expect).any()))
    return bits, flag


WIDTH_LENGTHS = (8, 16, 24, 32, 40, 64, 128, 136, 256, 512, 1024)
BATTERY = battery()


@pytest.mark.parametrize("L", WIDTH_LENGTHS)
@pytest.mark.parametrize("i", range(len(BATTERY)))
def test_widths_model_matches_plain_version(i, L):
    data = BATTERY[i]
    x = torch.from_numpy(data)
    first = k.frame_widths_ref(x, L)[0][:1].tolist()
    for fb in (0, 4, *first):
        bits, flag = _model_widths(data, L, fb)
        want_bits, want_flag = k.frame_widths_ref(x, L, fb)
        np.testing.assert_array_equal(bits, want_bits.numpy())
        assert flag == int(want_flag)


# ---------------------------------------------------------------------------
# Unpack
# ---------------------------------------------------------------------------

class _Payload:
    """The payload as the kernel sees it: ``size`` bytes at an address of
    the given 16-byte phase; every read is checked against values_size."""

    def __init__(self, values: np.ndarray, phase: int, values_size: int):
        self.v, self.phase, self.size = values, phase, values_size
        self.reads = 0

    def read(self, i: int, nbytes: int = 1) -> np.ndarray:
        assert 0 <= i and i + nbytes <= self.size, "read past values_size"
        if nbytes == 16:
            assert (self.phase + i) % 16 == 0, "unaligned 16-byte copy"
        self.reads += nbytes
        return self.v[i:i + nbytes]


def _model_unpack(payload: _Payload, n: int, frame_length: int,
                  bits=None, offs=None, fb: int = 0) -> np.ndarray:
    """flrl_unpack: the n bytes the kernel writes."""
    L = _launch_length(n, frame_length)
    U = _lane_bytes(L)
    span = WARP * U
    spans = -(-n // span)
    recip = (2 ** 64 - 1) // L + 1
    p = (np.arange(spans * WARP, dtype=np.uint64) * U64(U)).reshape(
        spans, WARP)
    active = p < n
    f = _umulhi(p, recip)
    assert (f[active] == p[active] // U64(L)).all()
    f = np.where(active, f, 0).astype(np.int64)
    p = p.astype(np.int64)
    if offs is not None:
        b = np.minimum(bits[f].astype(np.int64), 8)
        base = offs[f].astype(np.int64)
    else:
        b = np.full(f.shape, fb, np.int64)
        base = f * (L // 8 * fb)
    count = np.minimum(n - f * L, L)
    nbytes = (count * b + 7) // 8
    q = (p - f * L) // 8 * b
    start = np.where(active, base + q, 0)
    end = np.where(active, base + np.minimum(q + U // 8 * b, nbytes), 0)
    last = WARP - 1 - np.argmax(active[:, ::-1], axis=1)
    lo = start[:, 0]
    hi = np.minimum(end[np.arange(spans), last], payload.size)
    run = np.where(hi > lo, np.minimum(hi - lo, span), 0)
    phase = (payload.phase + lo) % 16
    head = np.minimum(run, (16 - phase) % 16)
    body = (run - head) // 16
    tail = run - head - 16 * body
    stage = np.full((spans, STAGE), 0xA5, np.uint8)    # junk never read
    for s in range(spans):
        at, ph = int(lo[s]), int(phase[s])
        h, nb, t = int(head[s]), int(body[s]), int(tail[s])
        assert nb <= WARP and h < 16 and t < 16
        assert ph + h + 16 * nb + t <= STAGE
        for i in range(h):
            stage[s, ph + i] = payload.read(at + i)[0]
        for j in range(nb):
            assert (ph + h + 16 * j) % 16 == 0       # aligned in the stage
            stage[s, ph + h + 16 * j:ph + h + 16 * j + 16] = payload.read(
                at + h + 16 * j, 16)
        for i in range(t):
            stage[s, ph + h + 16 * nb + i] = payload.read(
                at + h + 16 * nb + i)[0]
    # each lane: its bytes of the run, read as five aligned stage words
    off = start - lo[:, None]
    want = end - start
    have = np.where(active & (off >= 0) & (off < run[:, None]),
                    np.minimum(want, run[:, None] - off), 0)
    o = phase[:, None] + np.where(have > 0, off, 0)
    assert ((o & ~3) + 20 <= STAGE).all()
    idx = o[:, :, None] + np.arange(16)
    raw = stage[np.arange(spans)[:, None, None], idx]
    raw = np.where(np.arange(16) < have[:, :, None], raw, 0).astype(np.uint8)
    words = np.ascontiguousarray(raw).view(np.uint64)  # (spans, 32, 2)
    wlo, whi = words[..., 0], words[..., 1]
    bu = b.astype(np.uint64)
    mb = _mask(U64(8) * bu)
    w1 = np.where(b == 8, whi,
                  np.where(b == 0, U64(0),
                           ((wlo >> (U64(8) * bu))
                            | (whi << np.where(b == 0, U64(0),
                                               U64(64) - U64(8) * bu)))
                           & mb))
    o0 = _unpack8(wlo & mb, bu)
    o1 = _unpack8(w1, bu) if U == 16 else np.zeros_like(o0)
    lane_out = np.stack([o0, o1], -1).view(np.uint8).reshape(spans, WARP,
                                                             16)[..., :U]
    return lane_out.reshape(-1)[:n]


def _cycling(L, tail, period, seed):
    g = np.random.default_rng(seed)
    cycle = g.permutation(8)[:period] + 1
    widths = np.resize(cycle, 67)
    masks = ((1 << widths.astype(np.int64)) - 1).astype(np.uint8)
    d = g.integers(0, 256, (widths.size, L), np.uint8) & masks[:, None]
    d[:, 0] = masks
    d = d.reshape(-1)
    return d[:d.size - L + tail] if tail else d


def _layout(data, L):
    x = torch.from_numpy(data)
    bits, _ = k.frame_widths(x, L)
    offs = k.frame_offsets(bits, data.size, L)
    return x, bits, offs


def _check_unpack(data, L, phase, fb=0):
    x, bits, offs = _layout(data, L)
    n = data.size
    if fb:
        values = k.pack(x, L, fb=fb)
        want = k.unpack_ref(values, n, L, fb=fb).numpy()
        mode = dict(fb=fb)
    else:
        values = k.pack(x, L, bits=bits, offs=offs)
        want = k.unpack_ref(values, n, L, bits=bits, offs=offs).numpy()
        mode = dict(bits=bits.numpy(), offs=offs.numpy())
    payload = _Payload(values.numpy(), phase, values.numel())
    got = _model_unpack(payload, n, L, **mode)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)
    assert payload.reads == values.numel()      # each byte read once


@pytest.mark.parametrize("period", (3, 5, 7))
@pytest.mark.parametrize("L,tail", TAIL_CASES,
                         ids=[f"L{L}-tail{t}" for L, t in TAIL_CASES])
def test_unpack_model_on_cycling_widths(L, tail, period):
    data = _cycling(L, tail, period, 100 * L + 10 * tail + period)
    _check_unpack(data, L, (L + tail + period) % 16)


@pytest.mark.parametrize("b", range(1, 9))
@pytest.mark.parametrize("L,tail", TAIL_CASES,
                         ids=[f"L{L}-tail{t}" for L, t in TAIL_CASES])
def test_unpack_model_on_uniform_widths(L, tail, b):
    data = _cycling(L, tail, 1, 1000 * L + 10 * tail + b)
    data &= (1 << b) - 1
    data[::L] = (1 << b) - 1
    _check_unpack(data, L, (L + b) % 16)
    _check_unpack(data, L, (tail + b) % 16, fb=b)


@pytest.mark.parametrize("phase", range(16))
@pytest.mark.parametrize("L", (24, 128))
def test_unpack_model_at_every_phase(L, phase):
    g = np.random.default_rng(phase)
    data = _cycling(L, 7, 5, 31 * L + phase)
    _check_unpack(data, L, phase)
    data = g.integers(0, 8, 40 * L + 9).astype(np.uint8)
    data[::L] = 7
    _check_unpack(data, L, phase, fb=3)


@pytest.mark.parametrize("L", (1024, 1032, 1 << 20))
@pytest.mark.parametrize("n", (1, 17, 1000, 1024))
def test_unpack_model_on_a_frame_longer_than_the_stream(n, L):
    g = np.random.default_rng(n + L)
    data = g.integers(0, 64, n).astype(np.uint8)
    _check_unpack(data, L, n % 16)
    _check_unpack(data, L, 3, fb=6)


def test_unpack_model_reads_nothing_past_a_short_payload():
    """A payload cut short: the bytes the frames lack decode as zeros in
    the plain version, and the model reads nothing past values_size."""
    data = _cycling(128, 0, 3, 7)
    x, bits, offs = _layout(data, 128)
    values = k.pack(x, 128, bits=bits, offs=offs)[:-100]
    payload = _Payload(values.numpy(), 9, values.numel())
    got = _model_unpack(payload, data.size, 128, bits=bits.numpy(),
                        offs=offs.numpy())
    want = k.unpack_ref(values, data.size, 128, bits=bits, offs=offs)
    np.testing.assert_array_equal(got, want.numpy())
