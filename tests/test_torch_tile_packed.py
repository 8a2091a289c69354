"""The tile-packed field codec of the PyTorch package
(``ops/tile_packed_cuda.py``) against the JAX kernels it replaces:
``enc_packed``/``dec_packed`` of ``experiments/exp21_tile_packed.py``
(cursor layout) and of ``experiments/exp22_tile_packed2.py`` (sparse
layout), loaded by ``tests/torch_exp_scripts.py`` and run in interpret
mode.  Inputs are words from numpy seeds, tile by tile at widths that
reach every pack depth: all-zero tiles (depth 3), widths 1, 2, 3, 4, 5 and
8, and a width-1 tile with one width-3 frame (depth 1).  Compared: the
widths, the row offsets, the packed rows each layout defines (rows outside
them are unspecified) and the round trip.  Tolerance: exact (integer
functions)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_exp_scripts
from fl_rl_compression_mpi_tpu_torch.ops import _build
from fl_rl_compression_mpi_tpu_torch.ops import fl_fields_cuda
from fl_rl_compression_mpi_tpu_torch.ops import tile_packed_cuda as tp

# A tile's widths: "0" all zero bytes, b random bytes of width b, "mix" a
# width-1 tile whose first frame has width 3.
TILE_KINDS = ("0", "1", "2", "3", "4", "5", "8", "mix")
DEPTHS = [3, 3, 2, 1, 1, 0, 0, 1]
SCRIPTS = {"cursor": "exp21_tile_packed", "sparse": "exp22_tile_packed2"}


def tile_words(g, R: int, kinds=TILE_KINDS) -> np.ndarray:
    """u32 words (tiles·R, 128), one tile of each kind in turn."""
    tiles = []
    for kind in kinds:
        if kind == "0":
            t = np.zeros((R, 512), np.uint8)
        elif kind == "mix":
            t = g.integers(0, 2, (R, 512), np.uint8)
            t[0, :128] = g.integers(0, 8, 128, np.uint8)
            t[0, 0] = 4
        else:
            b = int(kind)
            t = g.integers(0, 1 << b, (R, 512), np.uint8)
            t[-1, -1] = 1 << (b - 1)
        tiles.append(t)
    return np.concatenate(tiles).view(np.uint32).reshape(-1, 128)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy())


def _jax_encode(layout, R, words):
    script = torch_exp_scripts.load(SCRIPTS[layout])
    out = script.enc_packed(R, words.shape[0])(jnp.asarray(words))
    bits, packed = np.array(out[0]), np.array(out[1])
    offs = np.array(out[2]) if layout == "cursor" else None
    return bits, packed, offs


def _jax_decode(layout, R, bits, packed, offs):
    script = torch_exp_scripts.load(SCRIPTS[layout])
    go = script.dec_packed(R, bits.shape[0])
    args = (bits, packed, offs) if layout == "cursor" else (bits, packed)
    return np.asarray(go(*[jnp.asarray(a) for a in args]))


_CASES = [(layout, R) for layout in tp.LAYOUTS for R in (8, 64)]


@pytest.fixture(scope="module")
def jax_runs():
    """(layout, R) -> (words, JAX encode, JAX decode of it), made once."""
    runs = {}
    for i, (layout, R) in enumerate(_CASES):
        words = tile_words(np.random.default_rng(10 + i), R)
        enc = _jax_encode(layout, R, words)
        runs[layout, R] = (words, enc, _jax_decode(layout, R, *enc))
    return runs


@pytest.mark.parametrize("layout,R", _CASES)
def test_encode_ref_matches_the_jax_kernel(jax_runs, layout, R):
    words, (jbits, jpacked, joffs), _ = jax_runs[layout, R]
    bits, packed, offs = tp.encode_ref(_t(words), R, layout)
    np.testing.assert_array_equal(bits.numpy(), jbits)
    assert tp.depths(bits, R).tolist() == DEPTHS
    if layout == "cursor":
        np.testing.assert_array_equal(offs.numpy(), joffs)
    else:
        assert offs is None
    rows = tp.defined_rows(bits, R, offs).numpy()
    assert rows.size == sum(R >> d for d in DEPTHS)
    np.testing.assert_array_equal(packed.numpy().view(np.uint32)[rows],
                                  jpacked[rows])


@pytest.mark.parametrize("layout,R", _CASES)
def test_decode_ref_matches_the_jax_kernel(jax_runs, layout, R):
    words, (jbits, jpacked, joffs), jout = jax_runs[layout, R]
    np.testing.assert_array_equal(jout, words)
    bits, packed, offs = tp.encode_ref(_t(words), R, layout)
    got = tp.decode_ref(bits, packed, R, offs)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), jout)
    # the JAX kernel's own packed rows decode the same
    cross = tp.decode_ref(torch.from_numpy(jbits),
                          torch.from_numpy(jpacked.view(np.int32)), R,
                          None if joffs is None else torch.from_numpy(joffs))
    np.testing.assert_array_equal(cross.numpy().view(np.uint32), words)


@pytest.mark.parametrize("layout", tp.LAYOUTS)
@pytest.mark.parametrize("R", [8, 16, 24, 64, 256])
def test_round_trip_at_every_depth(layout, R):
    """Full-range words at width 8 beside the other kinds, every tile size
    a multiple of 8 (24 is not a power of two)."""
    g = np.random.default_rng(R)
    kinds = TILE_KINDS + ("8",)
    words = tile_words(g, R, kinds)
    words[-R:] = g.integers(0, 1 << 32, (R, 128), dtype=np.uint64)
    bits, packed, offs = tp.encode(_t(words), R, layout)
    assert tp.depths(bits, R).tolist() == DEPTHS + [0]
    if layout == "cursor":
        assert offs.tolist() == np.concatenate(
            [[0], np.cumsum([R >> d for d in DEPTHS + [0]])]).tolist()
    out = tp.decode(bits, packed, R, offs)
    assert out.shape == (words.shape[0], 128) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy().view(np.uint32), words)


@pytest.mark.parametrize("layout", tp.LAYOUTS)
def test_rows_outside_the_tiles_are_not_read(layout):
    R = 16
    g = np.random.default_rng(5)
    words = tile_words(g, R)
    bits, packed, offs = tp.encode(_t(words), R, layout)
    junk = torch.from_numpy(g.integers(-(1 << 31), 1 << 31, packed.shape,
                                       dtype=np.int64).astype(np.int32))
    rows = tp.defined_rows(bits, R, offs)
    junk[rows] = packed[rows]
    np.testing.assert_array_equal(
        tp.decode(bits, junk, R, offs).numpy().view(np.uint32), words)


def test_widths_are_the_base_field_encodes():
    """exp21's bits_parity: the widths equal fl_fields_cuda's at L = 128."""
    words = tile_words(np.random.default_rng(6), 8)
    bits, _, _ = tp.encode(_t(words), 8)
    want, _ = fl_fields_cuda.encode_fields_ref(_t(words).reshape(-1))
    np.testing.assert_array_equal(bits.reshape(-1).numpy(), want.numpy())


def test_defined_rows():
    bits = torch.from_numpy(
        tile_words(np.random.default_rng(7), 8, ("8", "1", "3"))).view(
            torch.int32)
    b, _, offs = tp.encode(bits, 8, "cursor")
    assert tp.tile_rows(b, 8).tolist() == [8, 1, 4]
    assert tp.defined_rows(b, 8, offs).tolist() == list(range(13))
    assert tp.defined_rows(b, 8).tolist() == (list(range(8)) + [8]
                                              + [16, 17, 18, 19])


@pytest.mark.parametrize("layout", tp.LAYOUTS)
def test_on_cpu_no_launch(layout):
    tp.reset_launches()
    words = _t(tile_words(np.random.default_rng(8), 8))
    bits, packed, offs = tp.encode(words, 8, layout)
    tp.decode(bits, packed, 8, offs)
    assert tp.LAUNCHES == {"tile_packed_encode": 0, "tile_packed_decode": 0}


def test_empty_stream():
    words = torch.zeros((0, 128), dtype=torch.int32)
    bits, packed, offs = tp.encode(words, 8)
    assert bits.shape == (0, 4) and packed.shape == (0, 128)
    assert offs.tolist() == [0]
    assert tp.decode(bits, packed, 8, offs).shape == (0, 128)


@pytest.mark.parametrize("call", [
    lambda w: tp.encode(w, 12),                       # R % 8 != 0
    lambda w: tp.encode(w, 48),                       # rows % R != 0
    lambda w: tp.encode(w, 0),
    lambda w: tp.encode(w, 8, "dense"),
    lambda w: tp.encode(w.to(torch.int64), 8),
    lambda w: tp.encode(w.reshape(-1)[:100], 8),
    lambda w: tp.encode(w.t(), 8),
    lambda w: tp.decode(torch.zeros(64 * 4, dtype=torch.uint8), w, 24),
    lambda w: tp.decode(torch.zeros(63 * 4, dtype=torch.uint8), w, 8),
    lambda w: tp.decode(torch.zeros(64 * 4, dtype=torch.int32), w, 8),
    lambda w: tp.decode(torch.zeros(64 * 4, dtype=torch.uint8), w, 8,
                        torch.zeros(8, dtype=torch.int32)),
    lambda w: tp.decode(torch.zeros(64 * 4, dtype=torch.uint8), w, 8,
                        torch.zeros(9, dtype=torch.int64)),
])
def test_refusals(call):
    with pytest.raises(ValueError):
        call(torch.zeros((64, 128), dtype=torch.int32))


@pytest.mark.parametrize("name", ["flrl_tile_packed_encode",
                                  "flrl_tile_packed_decode"])
def test_launcher_signatures_match_the_header(name):
    with open(os.path.join(_build.CSRC_DIR, "tile_packed.cuh")) as f:
        proto = re.search(name + r"\(([^)]*)\)", f.read()).group(1)
    _, argtypes = _build._SIGNATURES[name]
    assert len(argtypes) == len(proto.split(","))
