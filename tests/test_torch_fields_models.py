"""NumPy models of the index math of the field kernels
(``csrc/fl_fields.cu``: ``encode_spans_kernel``, ``encode_pack2_kernel``,
``encode_frames_kernel``, ``decode_lanes_kernel``, ``decode_pack2_kernel``),
held against their plain PyTorch versions
(``fl_fields_cuda.encode_fields_ref``, ``decode_fields_ref``).

A CUDA kernel cannot run here, so each model repeats its kernel's
arithmetic step for step.  The encode: base mode's lanes of U bytes and
warp steps of kFieldsStep bytes (32 a lane), the spans' ORs carried in one
word through the xor-shuffle combine, the spread of each lane's words at
its frame's width and the widths' stage stored by ``store_widths``;
pack-2's packed row a step, its two input rows found by multiply-high,
both rows' ORs in one word (two frames a row at L = 8), and the two-row
packed store; any other L a warp a frame.  The decode: base mode's flat
lanes of U bytes for every L, a step of kFieldsStep bytes, the frame by
shift or multiply-high, one width load a group and the U-byte store;
pack-2's kDecodeRows packed rows a step, their tile by multiply-high, a
lane's packed group unspread into both rows, and the stores masked at nw
(rows past it, the row that holds it, and at L = 8 half a group).  The
decode models also check that no width at or past F, no slot past the
packed words and no output word at or past nw is touched.  Tolerance: byte
equality throughout."""

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
DECODE_ROWS = _constant("kDecodeRows")
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


# ---------------------------------------------------------------------------
# The decode
# ---------------------------------------------------------------------------

def _unspread(f, b) -> np.ndarray:
    """fl_fields.cu's unspread."""
    f = np.asarray(f, np.int64)
    b = np.asarray(b, np.int64)
    m = (1 << b) - 1
    return ((f & m) | (((f >> b) & m) << 8) | (((f >> 2 * b) & m) << 16)
            | (((f >> 3 * b) & m) << 24))


def _frame_of(p: np.ndarray, L: int) -> np.ndarray:
    """decode_lanes_kernel's frame of byte p < 2^32: a shift where L is a
    power of two, else one multiply-high by reciprocal(L)."""
    p = np.asarray(p, np.uint64)
    if L & (L - 1) == 0:
        return (p >> U64(L.bit_length() - 1)).astype(np.int64)
    return _umulhi(p, (2**64 - 1) // L + 1).astype(np.int64)


def _model_decode_lanes(fields: np.ndarray, bits: np.ndarray, L: int):
    """Base mode, every L: output words u32[nw] of u32 fields[nw]."""
    nw = fields.size
    n = 4 * nw
    U = _lane_bytes(L)
    assert L % U == 0 and n % L == 0
    span = WARP * U
    groups = STEP // span
    steps = -(-n // STEP)
    # byte p of lane `lane`'s group j in warp step s
    p = (np.arange(steps)[:, None, None] * STEP
         + np.arange(groups)[None, :, None] * span
         + np.arange(WARP)[None, None, :] * U).reshape(-1)
    p = p[p < n]                            # a group is all in or all past
    f = _frame_of(p, L)
    np.testing.assert_array_equal(f, p // L)
    assert f.max(initial=-1) < bits.size    # no width at or past F
    b = bits.astype(np.int64)[f]            # one width load a group
    words = fields.astype(np.int64)
    out = np.zeros(nw, np.int64)
    written = np.zeros(nw, np.int64)
    for q in range(U // 4):                 # the U-byte store
        w = p // 4 + q
        out[w] = _unspread(words[w], b)
        written[w] += 1
    assert (written == 1).all()
    return out.astype(np.uint32)


def _model_decode_pack2(slots: np.ndarray, bits: np.ndarray, L: int,
                        tile_r: int):
    """Pack-2 mode: output words u32[nw] of the u32 slot words."""
    wpf = L // 4
    nw = bits.size * wpf
    half = tile_r // 2
    G = 2 if L == 8 else 1
    sh = wpf.bit_length() - 1
    assert wpf == 1 << sh and half % 8 == 0
    rows = -(-nw // PACK_LANES)
    last = (rows - 1) // tile_r
    prows = last * half + min(rows - last * tile_r, half)
    steps = -(-prows // DECODE_ROWS)
    P = np.arange(steps, dtype=np.uint64) * U64(DECODE_ROWS)
    tile = _umulhi(P, (2**64 - 1) // half + 1)
    np.testing.assert_array_equal(tile, P // U64(half))
    P = P.astype(np.int64)
    lo = P + tile.astype(np.int64) * half
    apart = half * PACK_LANES
    lane = np.arange(WARP)
    x = slots.astype(np.int64)
    out = np.zeros(nw, np.int64)
    written = np.zeros(nw, np.int64)
    touched = []
    for r in range(DECODE_ROWS):
        assert ((P + r) // half == P // half).all()   # one tile a step
        w = ((lo + r)[:, None] * PACK_LANES + 4 * lane[None, :]).reshape(-1)
        g = ((P + r)[:, None] * PACK_LANES + 4 * lane[None, :]).reshape(-1)
        load = w < nw
        assert (g[load] + 4 <= slots.size).all(), "a slot past the layout"
        for start, half_of in ((w, lambda v: v & 0xFFFF),
                               (w + apart, lambda v: v >> 16)):
            keep = start < nw
            s0, g0 = start[keep], g[keep]
            f0 = s0 >> sh
            touched.append(f0)
            b0 = bits.astype(np.int64)[f0]
            b1 = b0
            two = s0 + 2 < nw               # the lane's second frame at L = 8
            if G == 2:
                touched.append(f0[two] + 1)
                b1 = np.where(two, bits.astype(np.int64)[
                    np.minimum(f0 + 1, bits.size - 1)], 0)
            words = 4 if G == 1 else np.where(two, 4, 2)
            for c in range(4):
                m = c < words
                bc = b0 if c < 2 else b1
                wc = (s0 + c)[m]
                out[wc] = _unspread(half_of(x[g0 + c][m]), np.broadcast_to(
                    bc, s0.shape)[m])
                written[wc] += 1
    assert (written == 1).all(), "a word stored twice, or never"
    t = np.concatenate(touched) if touched else np.zeros(0, np.int64)
    assert t.max(initial=-1) < bits.size, "a width at or past F"
    return out.astype(np.uint32)


def _check_decode(fields: np.ndarray, bits: np.ndarray, L: int,
                  tile_r: int = 0) -> None:
    got = (_model_decode_pack2(fields, bits, L, tile_r) if tile_r
           else _model_decode_lanes(fields, bits, L))
    want = fk.decode_fields_ref(torch.from_numpy(fields.view(np.int32)),
                                torch.from_numpy(bits), L, tile_r)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint32))


@pytest.mark.parametrize("L", BASE_LENGTHS)
@pytest.mark.parametrize("i", range(len(BATTERY)))
def test_base_decode_model_on_the_battery(i, L):
    bits, out = _model_encode(_padded(BATTERY[i], L), L)
    _check_decode(out, bits, L)


@pytest.mark.parametrize("L", PACK2_LENGTHS)
@pytest.mark.parametrize("i", range(len(BATTERY)))
def test_pack2_decode_model_on_the_battery(i, L):
    """The encode model's pack-2 slots of each battery stream, decoded
    frame by frame: any width > 4 keeps only its slot's 16 bits, as in
    the twin."""
    data = _padded(BATTERY[i], 16 * ROW)
    bits, slots = _model_encode(data, L, 16)
    frames = max(1, -(-BATTERY[i].size // L))
    _check_decode(slots, bits[:frames], L, 16)


def _pack2_ends(L: int, tile_r: int) -> dict:
    """Word counts nw that end a pack-2 stream at the masks' edges."""
    wpf = L // 4
    tw = tile_r * PACK_LANES
    ends = {"whole tiles": 2 * tw,
            "a whole row": 2 * tw + PACK_LANES,
            "wpf past a row boundary": 2 * tw + 3 * PACK_LANES + wpf,
            "first half of the last tile": 2 * tw + tw // 2 - 5 * PACK_LANES,
            "mid-row in the second half": 2 * tw + tw // 2 + PACK_LANES
            + PACK_LANES // 2,
            "mid-row in the first half": 2 * tw + 2 * PACK_LANES + 64,
            "one frame": wpf}
    if L == 8:
        ends["mid-group"] = 2 * tw + 7 * PACK_LANES + 42
    return {k: v // wpf * wpf for k, v in ends.items()}


@pytest.mark.parametrize("tile_r", [16, 2048])
@pytest.mark.parametrize("L", PACK2_LENGTHS)
def test_pack2_decode_model_at_its_masks(L, tile_r):
    """Every end of _pack2_ends on random slot words and widths 1..8
    (the twin and the kernel take a slot's low or high 16 bits whatever
    the width)."""
    g = np.random.default_rng(L * tile_r)
    for name, nw in _pack2_ends(L, tile_r).items():
        slots = g.integers(0, 2**32, fk.packed_words(nw, tile_r), np.uint32)
        bits = g.integers(1, 9, nw // (L // 4), np.uint8)
        if name == "mid-group":
            assert nw % 4 == 2 and nw % PACK_LANES
        _check_decode(slots, bits, L, tile_r)


@pytest.mark.parametrize("L", BASE_LENGTHS)
def test_base_decode_model_around_a_step(L):
    """Frame counts around a warp step, two steps and a partial last
    step, on random fields and widths 1..8."""
    g = np.random.default_rng(L + 1)
    per_step = max(1, STEP // L)
    for frames in sorted({1, per_step - 1, per_step, per_step + 1,
                          2 * per_step + 1} - {0}):
        nw = frames * L // 4
        _check_decode(g.integers(0, 2**32, nw, np.uint32),
                      g.integers(1, 9, frames, np.uint8), L)


@pytest.mark.parametrize("L", [24, 40, 136, 1032])
def test_frame_multiply_high_is_exact(L):
    """The base decode's p / L by multiply-high equals p // L for every
    group start p a launch can take (p < 2^31, a multiple of U), at the
    frame boundaries and on random positions."""
    U = _lane_bytes(L)
    top = (1 << 31) - U
    k = np.arange(1, top // L + 1, max(1, top // L // 200_000),
                  dtype=np.int64)
    edges = (k[:, None] * L + np.array([-U, 0, U])[None, :]).reshape(-1)
    g = np.random.default_rng(L)
    rand = g.integers(0, top // U + 1, 200_000) * U
    p = np.concatenate([edges, rand, [0, U, top]])
    p = p[(p >= 0) & (p <= top)]
    np.testing.assert_array_equal(_frame_of(p, L), p // L)
