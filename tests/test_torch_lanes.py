"""The flat-tile primitives of the PyTorch package (``ops/lanes_cuda.py``)
against the JAX package's ``ops/lanes.py``, run as ``tests/test_lanes.py``
runs them: one lane function over an (8, 128) int32 tile inside a Pallas
kernel in interpret mode, through a harness of this file's own.  Inputs
come from numpy seeds, with ``tests/test_lanes.py``'s parameters; tiles of
16 and 256 rows and stacks of several tiles are held against NumPy only
(interpret mode at large R is slow).  Tolerance: exact, element for element
(integer functions)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fl_rl_compression_mpi_tpu.ops import lanes
from fl_rl_compression_mpi_tpu_torch.ops import _build
from fl_rl_compression_mpi_tpu_torch.ops import lanes_cuda as lk

R = 8
N = R * 128
I32MIN, I32MAX = -(2 ** 31), 2 ** 31 - 1


def _pallas(fn, *arrays):
    """fn (taking and returning (R, 128) i32 arrays) as a Pallas kernel in
    interpret mode, on flat int arrays; returns the flat int64 result."""
    def kernel(*refs):
        refs[-1][...] = fn(*[r[...] for r in refs[:-1]])

    @jax.jit
    def go(*xs):
        return pl.pallas_call(
            kernel,
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(xs),
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((R, 128), jnp.int32),
            interpret=True,
        )(*xs)
    return np.asarray(go(*[jnp.asarray(_i32(a)).reshape(R, 128)
                           for a in arrays])).reshape(-1).astype(np.int64)


def _i32(a) -> np.ndarray:
    """int values → int32 with two's-complement wrap."""
    return np.asarray(a, np.int64).astype(np.uint32).view(np.int32)


def _t(a, rows: int = R) -> torch.Tensor:
    return torch.from_numpy(_i32(a).copy()).reshape(-1, rows, 128)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().reshape(-1).astype(np.int64)


def rng(seed):
    return np.random.default_rng(seed)


# NumPy semantics of each op on one flat tile
def np_shift(x, by, fill):
    n = x.size
    out = np.full(n, fill, np.int64)
    src = np.arange(n) + by
    ok = (src >= 0) & (src < n)
    out[ok] = x[src[ok]]
    return out


def np_route(w, nbits, sign):
    w = np.asarray(w, np.int64)
    n = w.size
    r = (w >> 16) & ((1 << nbits) - 1)
    dest = np.arange(n) + sign * r
    ok = (w < 0) & (dest >= 0) & (dest < n)
    out = np.zeros(n, np.int64)
    out[dest[ok]] = w[ok] - (r[ok] << 16)
    return out


def np_pack(live, dist, pay):
    return np.where(np.asarray(live) != 0,
                    I32MIN | (np.asarray(dist, np.int64) << 16)
                    | np.asarray(pay, np.int64), 0)


def np_wrap(v):
    return _i32(v).astype(np.int64)


def np_rounds(a, d):
    """d rounds of y·3 + roll(y, 1) on each row of 128, wrapping mod 2^32
    (experiments/exp33_round_latency.py's function)."""
    z = np.asarray(a, np.int64).reshape(-1, 128) & 0xFFFFFFFF
    for _ in range(d):
        z = (z * 3 + np.roll(z, 1, 1)) & 0xFFFFFFFF
    return np_wrap(z.reshape(-1))


def compaction(g, n, density, offset=0, high_bits=0, nbits=10):
    """Route words of a stream compaction: the live words keep a payload,
    distances p − (live words before p) + offset, and ``high_bits`` random
    bits above ``nbits`` in the dist field."""
    keep = g.random(n) < density
    keep[0] = True
    pay = g.integers(0, 1 << 16, n)
    dist = np.arange(n) - (np.cumsum(keep) - 1) + offset
    dist |= g.integers(0, 1 << high_bits, n) << nbits
    return keep, np.where(keep, dist, 0), pay


def expansion(g, n, nk, offset=0, high_bits=0, nbits=10, last=False):
    """Route words of an expansion: nk live words at 0..nk−1 to sorted
    random targets (+ offset), the tile's last slot among them if
    ``last``."""
    if last:
        targets = np.append(np.sort(g.choice(n - 1, nk - 1, replace=False)),
                            n - 1)
    else:
        targets = np.sort(g.choice(n, nk, replace=False))
    pay = g.integers(0, 1 << 16, n)
    dist = np.zeros(n, np.int64)
    dist[:nk] = targets - np.arange(nk) + offset
    dist[:nk] |= g.integers(0, 1 << high_bits, nk) << nbits
    live = (np.arange(n) < nk).astype(np.int64)
    return live, dist, pay, targets


# ---------------------------------------------------------------------------
# The plain versions against ops/lanes.py in the Pallas harness, R = 8
# ---------------------------------------------------------------------------

SHIFTS = [1, 2, 4, 64, 127, 128, 256, 384, 512]


@pytest.mark.parametrize("m", SHIFTS)
def test_flat_shift_down(m):
    x = rng(1).integers(0, 1 << 20, N)
    want = _pallas(lambda a: lanes.flat_shift_down(a, m, -7), x)
    got = _np(lk.flat_shift_down(_t(x), m, -7))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_shift(x, m, -7))


@pytest.mark.parametrize("m", SHIFTS)
def test_flat_shift_up(m):
    x = rng(2).integers(0, 1 << 20, N)
    want = _pallas(lambda a: lanes.flat_shift_up(a, m, -3), x)
    got = _np(lk.flat_shift_up(_t(x), m, -3))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_shift(x, -m, -3))


DYN = [0, 1, 63, 127, 128, 129, 500, N - 1]


@pytest.mark.parametrize("m", DYN)
def test_flat_shift_up_dyn(m):
    x = rng(3).integers(0, 1 << 20, N)
    mv = np.full(N, m)
    want = _pallas(lambda a, mm: lanes.flat_shift_up_dyn(a, mm[0, 0], -3),
                   x, mv)
    m_dev = torch.tensor([m], dtype=torch.int32)
    got = _np(lk.flat_shift_up_dyn(_t(x), m_dev, -3))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_shift(x, -m, -3))


@pytest.mark.parametrize("m", DYN)
def test_flat_shift_down_dyn(m):
    x = rng(3).integers(0, 1 << 20, N)
    mv = np.full(N, m)
    want = _pallas(lambda a, mm: lanes.flat_shift_down_dyn(a, mm[0, 0], -7),
                   x, mv)
    m_dev = torch.full((1, 1), m, dtype=torch.int32)
    got = _np(lk.flat_shift_down_dyn(_t(x), m_dev, -7))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_shift(x, m, -7))


FILLS = [None, 0, 500]


@pytest.mark.parametrize("fill", FILLS)
def test_prefix_max_flat(fill):
    x = rng(3).integers(-1000, 1000, N)
    kw = {} if fill is None else {"fill": fill}
    want = _pallas(lambda a: lanes.prefix_max_flat(a, **kw), x)
    got = _np(lk.prefix_max_flat(_t(x), **kw))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.maximum(np.maximum.accumulate(x),
                        I32MIN if fill is None else fill))


@pytest.mark.parametrize("lo,hi", [(0, 100), (1 << 30, 1 << 31),
                                   (I32MIN, 1 << 31)])
def test_prefix_sum_flat(lo, hi):
    """Small counts (test_lanes.py's), then large positive values and the
    whole int32 range, whose sums wrap as int32 does."""
    x = rng(4).integers(lo, hi, N)
    want = _pallas(lambda a: lanes.prefix_sum_flat(a), x)
    got = _np(lk.prefix_sum_flat(_t(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_wrap(np.cumsum(x)))


@pytest.mark.parametrize("fill", FILLS)
def test_suffix_min_flat(fill):
    x = rng(5).integers(-1000, 1000, N)
    kw = {} if fill is None else {"fill": fill}
    want = _pallas(lambda a: lanes.suffix_min_flat(a, **kw), x)
    got = _np(lk.suffix_min_flat(_t(x), **kw))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.minimum(np.minimum.accumulate(x[::-1])[::-1],
                        I32MAX if fill is None else fill))


def _routes(fn_jax, fn_ours, live, dist, pay, nbits):
    """The route through the Pallas harness and through the plain version
    on the same packed words; both packings must agree first."""
    def jfn(p, lv, ds):
        return fn_jax(lanes.pack_route(lv != 0, ds, p), nbits)
    want = _pallas(jfn, pay, live, dist)
    w = lk.pack_route(_t(live) != 0, _t(dist), _t(pay))
    np.testing.assert_array_equal(_np(w), np_wrap(np_pack(live, dist, pay)))
    return _np(fn_ours(w, nbits)), want, _np(w)


@pytest.mark.parametrize("seed,density", [(6, 0.02), (7, 0.3), (8, 0.9),
                                          (9, 1.0)])
def test_compact_lsb(seed, density):
    keep, dist, pay = compaction(rng(seed), N, density)
    got, want, w = _routes(lanes.compact_lsb, lk.compact_lsb, keep, dist,
                           pay, 10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_route(w, 10, -1))
    K = keep.sum()
    np.testing.assert_array_equal(got[:K] & 0xFFFF, pay[keep])
    assert (got[:K] < 0).all() and (got[K:] == 0).all()


@pytest.mark.parametrize("seed,nk", [(10, 13), (11, 300), (12, 1024)])
def test_expand_msb(seed, nk):
    live, dist, pay, targets = expansion(rng(seed), N, nk)
    got, want, w = _routes(lanes.expand_msb, lk.expand_msb, live, dist, pay,
                           10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_route(w, 10, 1))
    np.testing.assert_array_equal(got[targets] & 0xFFFF, pay[:nk])
    np.testing.assert_array_equal(np.flatnonzero(got < 0), targets)


@pytest.mark.parametrize("nbits", [10, 11, 13])
def test_compact_lsb_keeps_dist_bits_above_nbits(nbits):
    """The networks consume only the low nbits of the dist field: the bits
    above stay in the word that lands."""
    keep, dist, pay = compaction(rng(20 + nbits), N, 0.4,
                                 high_bits=15 - nbits, nbits=nbits)
    got, want, w = _routes(lanes.compact_lsb, lk.compact_lsb, keep, dist,
                           pay, nbits)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_route(w, nbits, -1))
    K = keep.sum()
    np.testing.assert_array_equal((got[:K] >> 16) & 0x7FFF,
                                  dist[keep] >> nbits << nbits)


@pytest.mark.parametrize("nbits", [10, 12])
def test_expand_msb_keeps_dist_bits_above_nbits(nbits):
    live, dist, pay, targets = expansion(rng(30 + nbits), N, 200,
                                         high_bits=15 - nbits, nbits=nbits)
    got, want, w = _routes(lanes.expand_msb, lk.expand_msb, live, dist, pay,
                           nbits)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_route(w, nbits, 1))
    np.testing.assert_array_equal(np.flatnonzero(got < 0), targets)


@pytest.mark.parametrize("offset", [1, 9, 200])
def test_compact_lsb_drops_words_past_the_head(offset):
    """Distances raised by ``offset``: the live words whose p − r < 0 leave
    the tile; the others land ``offset`` lower than a compaction would."""
    keep, dist, pay = compaction(rng(40 + offset), N, 0.5, offset=offset)
    got, want, w = _routes(lanes.compact_lsb, lk.compact_lsb, keep, dist,
                           pay, 11)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_route(w, 11, -1))
    K = keep.sum()
    assert (got[:K - offset] < 0).all() and (got[K - offset:] == 0).all()
    np.testing.assert_array_equal(got[:K - offset] & 0xFFFF,
                                  pay[keep][offset:])


@pytest.mark.parametrize("offset", [1, 9, 200])
def test_expand_msb_drops_words_past_the_tail(offset):
    live, dist, pay, targets = expansion(rng(50 + offset), N, 400,
                                         offset=offset, last=True)
    got, want, w = _routes(lanes.expand_msb, lk.expand_msb, live, dist, pay,
                           11)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_route(w, 11, 1))
    kept = targets + offset < N
    assert not kept.all()
    np.testing.assert_array_equal(np.flatnonzero(got < 0),
                                  targets[kept] + offset)


# ---------------------------------------------------------------------------
# Larger tiles and stacks of tiles, against NumPy
# ---------------------------------------------------------------------------

def _cases(n, g, nbits):
    """op → (call on a tensor of tiles, NumPy on one flat tile, input)."""
    x = g.integers(I32MIN, I32MAX, n, endpoint=True)
    # words leave the tile's edge where nbits leaves room for it
    offset = 3 if nbits > (n - 1).bit_length() else 0
    keep, dist, pay = compaction(g, n, g.random(), offset=offset)
    cw = np_wrap(np_pack(keep, dist, pay))
    live, edist, epay, _ = expansion(g, n, int(g.integers(1, n)),
                                     offset=offset)
    ew = np_wrap(np_pack(live, edist, epay))
    m = int(g.integers(0, n))
    md = torch.tensor([m], dtype=torch.int32)
    return {
        "shift_down": (lambda t: lk.flat_shift_down(t, 129, -7),
                       lambda a: np_shift(a, 129, -7), x),
        "shift_up": (lambda t: lk.flat_shift_up(t, n - 128, -3),
                     lambda a: np_shift(a, 128 - n, -3), x),
        "shift_down_dyn": (lambda t: lk.flat_shift_down_dyn(t, md, 5),
                           lambda a: np_shift(a, m, 5), x),
        "shift_up_dyn": (lambda t: lk.flat_shift_up_dyn(t, md, 5),
                         lambda a: np_shift(a, -m, 5), x),
        "prefix_max": (lambda t: lk.prefix_max_flat(t),
                       lambda a: np.maximum.accumulate(a), x),
        "prefix_sum": (lambda t: lk.prefix_sum_flat(t),
                       lambda a: np_wrap(np.cumsum(a)), x),
        "suffix_min": (lambda t: lk.suffix_min_flat(t),
                       lambda a: np.minimum.accumulate(a[::-1])[::-1], x),
        "compact": (lambda t: lk.compact_lsb(t, nbits),
                    lambda a: np_route(a, nbits, -1), cw),
        "expand": (lambda t: lk.expand_msb(t, nbits),
                   lambda a: np_route(a, nbits, 1), ew),
        "rounds": (lambda t: lk.rounds(t, 64), lambda a: np_rounds(a, 64), x),
    }


@pytest.mark.parametrize("rows", [16, 256])
@pytest.mark.parametrize("op", lk.OPS)
def test_large_tiles_match_numpy(op, rows):
    n = rows * 128
    nbits = min(15, n.bit_length())
    call, ref, a = _cases(n, rng(60 + rows), nbits)[op]
    got = call(_t(a, rows))
    assert got.shape == (1, rows, 128) and got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), ref(a))


@pytest.mark.parametrize("op", lk.OPS)
def test_tiles_do_not_leak_into_each_other(op):
    """Three 8-row tiles in one call: each equals the op on that tile
    alone, so no shift, scan or route crosses a tile's edge."""
    g = rng(70)
    cases = [_cases(N, g, 11) for _ in range(3)]
    call, ref, _ = cases[0][op]
    stack = np.concatenate([c[op][2] for c in cases])
    got = _np(call(_t(stack)))
    for i, c in enumerate(cases):
        np.testing.assert_array_equal(got[i * N:(i + 1) * N], ref(c[op][2]))


@pytest.mark.parametrize("op", lk.OPS)
def test_on_cpu_no_launch_and_no_tiles(op):
    """CPU tensors take the plain version and count no launch; a tensor of
    no tiles gives an empty result of its shape."""
    call, ref, a = _cases(N, rng(80), 11)[op]
    lk.reset_launches()
    np.testing.assert_array_equal(_np(call(_t(a))), ref(a))
    empty = call(torch.zeros((0, R, 128), dtype=torch.int32))
    assert empty.shape == (0, R, 128)
    assert lk.LAUNCHES["tile_op"] == 0


# ---------------------------------------------------------------------------
# What the wrappers refuse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [
    ((4, 128), torch.int32), ((12, 128), torch.int32),
    ((24, 128), torch.int32), ((512, 128), torch.int32),
    ((8, 64), torch.int32), ((1024,), torch.int32),
    ((8, 128), torch.int64), ((8, 128), torch.uint8),
    ((8, 128), torch.float32)])
def test_refuses_rows_and_dtypes(shape, dtype):
    x = torch.zeros(shape, dtype=dtype)
    for fn in (lambda t: lk.flat_shift_down(t, 1, 0),
               lambda t: lk.prefix_sum_flat(t),
               lambda t: lk.compact_lsb(t, 10)):
        with pytest.raises(ValueError):
            fn(x)


@pytest.mark.parametrize("call", [
    lambda x: lk.flat_shift_down(torch.zeros((128, 8), dtype=torch.int32).t(),
                                 1, 0),
    lambda x: lk.flat_shift_up(x, -1, 0),
    lambda x: lk.flat_shift_up(x, 1, 2 ** 31),
    lambda x: lk.flat_shift_up_dyn(x, torch.tensor([1]), 0),
    lambda x: lk.flat_shift_down_dyn(x, torch.tensor([1, 2],
                                                     dtype=torch.int32), 0),
    lambda x: lk.compact_lsb(x, 16),
    lambda x: lk.expand_msb(x, -1),
    lambda x: lk.prefix_max_flat(x.to("meta")),
])
def test_refuses_other_arguments(call):
    with pytest.raises(ValueError):
        call(torch.zeros((8, 128), dtype=torch.int32))


# ---------------------------------------------------------------------------
# The wrapper and the kernel's header agree
# ---------------------------------------------------------------------------

def _header() -> str:
    with open(os.path.join(_build.CSRC_DIR, "lanes.cuh")) as f:
        return f.read()


def test_ops_follow_the_headers_enum():
    enum = re.search(r"enum FlrlTileOp \{([^}]*)\}", _header()).group(1)
    values = dict(re.findall(r"kTile(\w+) = (\d+)", enum))
    names = {re.sub(r"(?<!^)([A-Z])", r"_\1", k).lower(): int(v)
             for k, v in values.items()}
    assert names == {op: i for i, op in enumerate(lk.OPS)}


def test_rows_follow_the_header():
    h = _header()
    assert int(re.search(r"kTileMinRows = (\d+)", h).group(1)) == lk.MIN_ROWS
    assert int(re.search(r"kTileMaxRows = (\d+)", h).group(1)) == lk.MAX_ROWS
    assert int(re.search(r"kTileLanes = (\d+)", h).group(1)) == lk.LANES


def test_launcher_signature_matches_the_header():
    proto = re.search(r"flrl_tile_op\(([^)]*)\)", _header()).group(1)
    _, argtypes = _build._SIGNATURES["flrl_tile_op"]
    assert len(argtypes) == len(proto.split(","))
