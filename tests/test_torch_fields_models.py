"""NumPy models of the index math of the field encode kernels
(``csrc/fl_fields.cu``: ``encode_spans_kernel``, ``encode_pack2_kernel``,
``encode_frames_kernel``), held against their plain PyTorch version
(``fl_fields_cuda.encode_fields_ref``).

A CUDA kernel cannot run here, so each model repeats its kernel's
arithmetic step for step: base mode's lanes of U bytes and warp steps of
kFieldsStep bytes (32 a lane), the spans' ORs carried in one word through the
xor-shuffle combine, the spread of each lane's words at its frame's width
and the widths' stage stored by ``store_widths``; pack-2's packed row a
step, its two input rows found by multiply-high, both rows' ORs in one word
(two frames a row at L = 8), and the two-row packed store; any other L a
warp a frame.  Tolerance: byte equality throughout."""

import os
import re

import numpy as np
import pytest
import torch

from fuzz_battery import battery
from fl_rl_compression_mpi_tpu_torch.ops import fl_fields_cuda as fk

WARP = 32
U64 = np.uint64
CSRC = os.path.join(os.path.dirname(fk.__file__), "..", "csrc")


def _constant(name: str) -> int:
    """A constant of csrc/fl_fields.cuh: a product of integers and kWarp."""
    with open(os.path.join(CSRC, "fl_fields.cuh")) as f:
        expr = re.search(rf"constexpr int {name} = ([^;]+);", f.read())
    terms = expr.group(1).replace("kWarp", str(WARP)).split("*")
    return int(np.prod([int(t) for t in terms]))


STEP = _constant("kFieldsStep")
PACK_LANES = _constant("kPackLanes")
ROW = 4 * PACK_LANES                        # bytes of a pack-2 row
PACK2_LENGTHS = (8, 16, 32, 64, 128, 256, 512)


def _lane_bytes(L: int) -> int:
    return 16 if L % 16 == 0 else 8


def _width(m) -> np.ndarray:
    """lane_io.cuh's width_of: max(1, bitlen(m))."""
    return np.maximum(1, np.frexp(np.asarray(m, np.float64))[1]).astype(
        np.int64)


def _or_bytes(x) -> np.ndarray:
    x = np.asarray(x, np.int64)
    x = x | (x >> 16)
    return (x | (x >> 8)) & 0xFF


def _spread(x, b) -> np.ndarray:
    """fl_fields.cu's spread, truncated to 32 bits as in the kernel."""
    x = np.asarray(x, np.int64)
    b = np.asarray(b, np.int64)
    f = ((x & 0xFF) | (((x >> 8) & 0xFF) << b) | (((x >> 16) & 0xFF) << 2 * b)
         | ((x >> 24) << 3 * b))
    return f & 0xFFFFFFFF


def _xor_combine(m: np.ndarray, k: int) -> np.ndarray:
    """k rounds of __shfl_xor_sync over the warp's lanes (last axis)."""
    lane = np.arange(WARP)
    for i in range(k):
        m = m | m[..., lane ^ (1 << i)]
    return m


def _store_widths(bits, f0, stage, count, whole):
    """lane_io.cuh's store_widths, with the alignment each store needs."""
    if count == whole and whole >= 16:
        assert f0 % 16 == 0
    elif count == whole and whole in (4, 8):
        assert f0 % whole == 0
    assert (stage[:count] > 0).all(), "a width the stage never got"
    bits[f0:f0 + count] = stage[:count]


def _model_spans(data: np.ndarray, L: int):
    """Base mode, L dividing the span: (bits, out words u32)."""
    n = data.size
    U = _lane_bytes(L)
    span = WARP * U
    k = (L // U).bit_length() - 1
    assert L == U << k and span % L == 0
    per_span = WARP >> k
    SPANS = STEP // span
    whole = SPANS * per_span
    step = STEP
    steps = -(-n // step)
    frames = n // L
    buf = np.zeros(steps * step, np.uint8)  # loads past n are zeros
    buf[:n] = data
    lanes = buf.reshape(steps, SPANS, WARP, U)
    m = np.zeros((steps, WARP), np.int64)   # byte j: span j
    for j in range(SPANS):
        words = lanes[:, j].copy().view("<u4").astype(np.int64)
        m |= _or_bytes(np.bitwise_or.reduce(words, -1)) << (8 * j)
    m = _xor_combine(m, k)
    b = np.stack([_width((m >> (8 * j)) & 0xFF) for j in range(SPANS)], 1)
    # every lane of a frame holds the frame's OR
    seg = b.reshape(steps, SPANS, per_span, 1 << k)
    assert (seg == seg[..., :1]).all()
    words = buf.view("<u4").reshape(steps, SPANS, WARP, U // 4)
    out = _spread(words, b[..., None]).reshape(-1)[:n // 4]
    bits = np.zeros(frames, np.int64)
    lane = np.arange(WARP)
    first = lane[(lane & ((1 << k) - 1)) == 0]
    for s in range(steps):
        f0 = s * whole
        stage = np.zeros(whole, np.int64)
        for j in range(SPANS):
            g = j * per_span + (first >> k)
            keep = f0 + g < frames
            stage[g[keep]] = b[s, j, first[keep]]
        _store_widths(bits, f0, stage, min(frames - f0, whole), whole)
    return bits.astype(np.uint8), out.astype(np.uint32)


def _model_frames(data: np.ndarray, L: int):
    """Base mode, any other L: a warp a frame."""
    n = data.size
    U = _lane_bytes(L)
    frames = n // L
    trips = -(-L // (WARP * U))
    words = data.view("<u4").astype(np.int64).reshape(frames, L // 4)
    pad = np.zeros((frames, trips * WARP * U // 4), np.int64)
    pad[:, :L // 4] = words                 # lanes past the frame load none
    lanes = pad.reshape(frames, trips, WARP, U // 4)
    o = _or_bytes(np.bitwise_or.reduce(lanes, axis=(1, 3)))
    b = _width(np.bitwise_or.reduce(o, 1))  # __reduce_or_sync
    out = _spread(words, b[:, None]).reshape(-1)
    return b.astype(np.uint8), out.astype(np.uint32)


def _umulhi(p: np.ndarray, recip: int) -> np.ndarray:
    hi, lo = U64(recip >> 32), U64(recip & 0xFFFFFFFF)
    return (p * hi + ((p * lo) >> U64(32))) >> U64(32)


def _model_pack2(data: np.ndarray, L: int, tile_r: int):
    """Pack-2 mode: (bits, packed words u32)."""
    n = data.size
    rows = n // ROW
    half = tile_r // 2
    steps = rows // 2                       # packed rows
    G = 2 if L == 8 else 1
    k = (L // 16).bit_length() - 1 if L >= 16 else 0
    per_row = ROW // L
    P = np.arange(steps, dtype=np.uint64)
    tile = _umulhi(P, (2**64 - 1) // half + 1)
    assert (tile == P // U64(half)).all()
    lo = (P + tile * U64(half)).astype(np.int64)
    assert ((lo // half) % 2 == 0).all()    # the tile's first half
    w = data.view("<u4").astype(np.int64).reshape(rows, WARP, 4)
    x, y = w[lo], w[lo + half]              # the lane's group of both rows
    if G == 2:
        m = (_or_bytes(x[..., 0] | x[..., 1]) | _or_bytes(x[..., 2] | x[..., 3])
             << 8 | _or_bytes(y[..., 0] | y[..., 1]) << 16
             | _or_bytes(y[..., 2] | y[..., 3]) << 24)
    else:
        m = (_or_bytes(np.bitwise_or.reduce(x, -1))
             | _or_bytes(np.bitwise_or.reduce(y, -1)) << 8)
    m = _xor_combine(m, k)
    x0, y0 = _width(m & 0xFF), _width((m >> (8 * G)) & 0xFF)
    x1 = _width((m >> 8) & 0xFF) if G == 2 else x0
    y1 = _width(m >> 24) if G == 2 else y0
    bx = np.stack([x0, x0, x1, x1], -1)
    by = np.stack([y0, y0, y1, y1], -1)
    packed = (_spread(x, bx) & 0xFFFF) | ((_spread(y, by) << 16) & 0xFFFFFFFF)
    frames = n // L
    bits = np.zeros(frames, np.int64)
    lane = np.arange(WARP)
    first = lane[(lane & ((1 << k) - 1)) == 0]
    for s in range(steps):
        stage = np.zeros(2 * per_row, np.int64)
        if G == 2:
            stage[2 * lane], stage[2 * lane + 1] = x0[s], x1[s]
            stage[per_row + 2 * lane] = y0[s]
            stage[per_row + 2 * lane + 1] = y1[s]
        else:
            stage[first >> k] = x0[s, first]
            stage[per_row + (first >> k)] = y0[s, first]
        _store_widths(bits, int(lo[s]) * per_row, stage, per_row, per_row)
        _store_widths(bits, int(lo[s] + half) * per_row, stage[per_row:],
                      per_row, per_row)
    return bits.astype(np.uint8), packed.reshape(-1).astype(np.uint32)


def _model_encode(data: np.ndarray, L: int, tile_r: int = 0):
    """flrl_fields_encode's dispatch, as its launcher takes it."""
    if tile_r:
        return _model_pack2(data, L, tile_r)
    if WARP * _lane_bytes(L) % L == 0:
        return _model_spans(data, L)
    return _model_frames(data, L)


def _padded(data: np.ndarray, unit: int) -> np.ndarray:
    """Zero-padded to a multiple of ``unit`` bytes (at least one)."""
    buf = np.zeros(max(1, -(-data.size // unit)) * unit, np.uint8)
    buf[:data.size] = data
    return buf


def _check(data: np.ndarray, L: int, tile_r: int = 0):
    bits, out = _model_encode(data, L, tile_r)
    want_bits, want_out = fk.encode_fields_ref(
        torch.from_numpy(data.view(np.int32)), L, tile_r)
    np.testing.assert_array_equal(bits, want_bits.numpy())
    np.testing.assert_array_equal(out, want_out.numpy().view(np.uint32))
    return bits


BASE_LENGTHS = (8, 16, 24, 32, 40, 64, 128, 136, 256, 512, 1024, 1032)
BATTERY = battery()


@pytest.mark.parametrize("L", BASE_LENGTHS)
@pytest.mark.parametrize("i", range(len(BATTERY)))
def test_base_model_on_the_battery(i, L):
    _check(_padded(BATTERY[i], L), L)


@pytest.mark.parametrize("L", PACK2_LENGTHS)
@pytest.mark.parametrize("i", range(len(BATTERY)))
def test_pack2_model_on_the_battery(i, L):
    """Battery streams at 16-row tiles; any width > 4 keeps only its
    fields' low 16 bits, as the twin does."""
    _check(_padded(BATTERY[i], 16 * ROW), L, 16)


def _frames_of_widths(g, widths, L):
    masks = ((1 << widths.astype(np.int64)) - 1).astype(np.uint8)
    d = g.integers(0, 256, (widths.size, L), np.uint8) & masks[:, None]
    d[:, 0] = masks
    return d.reshape(-1)


@pytest.mark.parametrize("kind", ["w<=4, one w5 in the last tile",
                                  "random widths"])
@pytest.mark.parametrize("tile_r", [16, 2048])
@pytest.mark.parametrize("L", PACK2_LENGTHS)
def test_pack2_model_on_whole_tiles(L, tile_r, kind):
    g = np.random.default_rng(L + tile_r)
    tiles = 3 if tile_r == 16 else 2
    frames = tiles * tile_r * ROW // L
    top = 4 if kind.startswith("w<=4") else 8
    data = _frames_of_widths(g, g.integers(1, top + 1, frames), L)
    if top == 4:
        data[-L - 3] = 17                   # width 5, in the last tile
    bits = _check(data, L, tile_r)
    assert bits.max() == 5 if top == 4 else True
    # and the base mode of the same words
    _check(data, L)


@pytest.mark.parametrize("L", BASE_LENGTHS)
def test_base_model_around_a_step(L):
    """Frame counts around a warp step, two steps and a partial last step."""
    g = np.random.default_rng(L)
    U = _lane_bytes(L)
    per_step = STEP // L if WARP * U % L == 0 else 1
    for frames in sorted({1, per_step - 1, per_step, per_step + 1,
                          2 * per_step + 1} - {0}):
        data = _frames_of_widths(g, g.integers(1, 9, frames), L)
        _check(data, L)


def test_xor_combine_carries_several_ors_in_one_word():
    """After log2(lanes) xor rounds, byte j of every lane is the OR of
    byte j over the lanes of its aligned segment, for every byte at
    once."""
    g = np.random.default_rng(3)
    for k in range(6):
        m = g.integers(0, 2**32, (50, WARP), np.int64)
        got = _xor_combine(m, k)
        seg = m.reshape(50, WARP >> k, 1 << k)
        want = np.bitwise_or.reduce(seg, -1, keepdims=True)
        np.testing.assert_array_equal(
            got, np.broadcast_to(want, seg.shape).reshape(50, WARP))


def test_header_constants_match_the_wrapper():
    assert PACK_LANES == fk.LANES
    assert STEP // 8 <= _constant("kFieldsStage")   # L = 8: a width a lane
    assert STEP % (WARP * 16) == 0 and STEP // (WARP * 8) <= 4
    # pack-2's widths of both rows fit the same stage
    assert 2 * ROW // 8 <= _constant("kFieldsStage")
