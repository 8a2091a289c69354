"""Plain PyTorch versions of the dense kernels (what a CPU tensor runs)
against the NumPy golden; ``test_torch_fl_dense_pallas.py`` holds them
against the TPU's Pallas kernels.  Tolerance: byte equality throughout."""

import os
import re

import numpy as np
import pytest
import torch

from fuzz_battery import battery
from fl_rl_compression_mpi_tpu.ops import fl_dense_pallas, fl_numpy
from fl_rl_compression_mpi_tpu_torch.ops import fl_dense_cuda as k

FRAME_LENGTHS = (8, 24, 40, 64, 128, 136, 256, 1024)
# The pack kernel's lane groups are 16 bytes where L % 16 == 0, else 8:
# tails around both, and widths that change inside a warp's span.
PACK_LENGTHS = (8, 24, 40, 64, 128, 136, 1024)
PACK_TAILS = (0, 1, 7, 8, 9, 15, 16, 17)
TAIL_CASES = [(L, t) for L in PACK_LENGTHS
              for t in sorted({t % L for t in PACK_TAILS} | {L - 1})]


def _width_cases():
    g = np.random.default_rng(7)
    out = []
    for b in range(1, 9):
        d = g.integers(0, 1 << b, 3000 + 13 * b).astype(np.uint8)
        d[::61] = (1 << b) - 1          # pins the width of most frames
        out.append((f"w{b}", d))
    return out


CASES = ([(f"battery{i}", d) for i, d in enumerate(battery())]
         + _width_cases())


def _roundtrip(data: np.ndarray, L: int):
    x = torch.from_numpy(data)
    n = data.size
    bits, flag = k.frame_widths(x, L)
    offs = k.frame_offsets(bits, n, L)
    values = k.pack(x, L, bits=bits, offs=offs)
    out = k.unpack(values, n, L, bits=bits, offs=offs)
    return bits, flag, offs, values, out


@pytest.mark.parametrize("L", FRAME_LENGTHS)
@pytest.mark.parametrize("name,data", CASES, ids=[c[0] for c in CASES])
def test_plain_versions_match_numpy_golden(name, data, L):
    before = dict(k.LAUNCHES)
    bits, flag, offs, values, out = _roundtrip(data, L)
    bg, vg = fl_numpy.encode(data, L)
    np.testing.assert_array_equal(bits.numpy(), bg)
    assert int(flag) == 0
    assert int(offs[-1]) == vg.size
    np.testing.assert_array_equal(values.numpy(), vg)
    np.testing.assert_array_equal(out.numpy(), data)
    if data.size and bool((bits == bits[0]).all()):
        fb = int(bits[0])
        x = torch.from_numpy(data)
        assert int(k.frame_widths(x, L, fb_expect=fb)[1]) == 0
        vu = k.pack(x, L, fb=fb)
        np.testing.assert_array_equal(vu.numpy(), vg)
        np.testing.assert_array_equal(
            k.unpack(vu, data.size, L, fb=fb).numpy(), data)
    # CPU tensors run the plain versions: no kernel launch is counted
    assert k.LAUNCHES == before


def _frames_of_widths(g, widths, L):
    masks = ((1 << widths.astype(np.int64)) - 1).astype(np.uint8)
    d = g.integers(0, 256, (widths.size, L), np.uint8) & masks[:, None]
    d[:, 0] = masks
    return d.reshape(-1)


def _cut(data, L, tail):
    """The stream with its last frame holding ``tail`` bytes (0: whole)."""
    return data[:data.size - L + tail] if tail else data


def _check_against_golden(data, L):
    bits, flag, offs, values, out = _roundtrip(data, L)
    bg, vg = fl_numpy.encode(data, L)
    np.testing.assert_array_equal(bits.numpy(), bg)
    fbytes = (bg.astype(np.int64) * np.minimum(
        data.size - np.arange(bg.size) * L, L) + 7) // 8
    np.testing.assert_array_equal(offs.numpy()[1:], np.cumsum(fbytes))
    assert int(offs[0]) == 0
    np.testing.assert_array_equal(values.numpy(), vg)
    np.testing.assert_array_equal(out.numpy(), data)
    np.testing.assert_array_equal(fl_numpy.decode(data.size, bg, vg, L), data)
    return bg, vg


@pytest.mark.parametrize("period", (3, 5, 7))
@pytest.mark.parametrize("L,tail", TAIL_CASES,
                         ids=[f"L{L}-tail{t}" for L, t in TAIL_CASES])
def test_plain_versions_on_cycling_widths(L, tail, period):
    """Widths cycling through ``period`` distinct values, so every group of
    four frames (a warp's span at L = 128) mixes widths."""
    g = np.random.default_rng(1000 * L + 10 * tail + period)
    cycle = g.permutation(8)[:period] + 1
    data = _cut(_frames_of_widths(g, np.resize(cycle, 67), L), L, tail)
    _check_against_golden(data, L)


@pytest.mark.parametrize("b", range(1, 9))
@pytest.mark.parametrize("L,tail", TAIL_CASES,
                         ids=[f"L{L}-tail{t}" for L, t in TAIL_CASES])
def test_uniform_pack_on_tails(L, tail, b):
    g = np.random.default_rng(1000 * L + 10 * tail + b)
    data = _cut(_frames_of_widths(g, np.full(33, b), L), L, tail)
    _, vg = _check_against_golden(data, L)
    x = torch.from_numpy(data)
    assert int(k.frame_widths(x, L, fb_expect=b)[1]) == 0
    vu = k.pack(x, L, fb=b)
    np.testing.assert_array_equal(vu.numpy(), vg)
    np.testing.assert_array_equal(k.unpack(vu, data.size, L, fb=b).numpy(),
                                  data)


SCAN_FRAMES = (1, k.OFFSETS_TILE - 1, k.OFFSETS_TILE, k.OFFSETS_TILE + 1,
               2 * k.OFFSETS_TILE + 1)


@pytest.mark.parametrize("L,tail", ((8, 0), (24, 5), (128, 77)))
@pytest.mark.parametrize("frames", SCAN_FRAMES)
def test_plain_versions_around_the_scan_tile(frames, L, tail):
    g = np.random.default_rng(frames + L)
    widths = g.integers(1, 9, frames)
    _check_against_golden(_cut(_frames_of_widths(g, widths, L), L, tail), L)


def test_offsets_tile_matches_the_cuda_source():
    path = os.path.join(os.path.dirname(k.__file__), "..", "csrc",
                        "fl_dense.cuh")
    src = open(path).read()
    threads = int(re.search(r"kOffsetsThreads = (\d+);", src).group(1))
    items = int(re.search(r"kOffsetsItems = (\d+);", src).group(1))
    assert threads * items == k.OFFSETS_TILE


def test_widths_flag_fires_on_mixed_stream():
    g = np.random.default_rng(3)
    data = g.integers(0, 16, 4096, np.uint8)
    data[128 * 5] = 200                  # one frame of width 8
    _, flag = k.frame_widths(torch.from_numpy(data), 128, fb_expect=4)
    assert int(flag) == 1


def test_host_probe_uniform_b_matches_tpu_probe():
    """The copy agrees with the TPU probe wherever the TPU had masks; the
    TPU's mask-availability clause is gone."""
    g = np.random.default_rng(5)
    R = 8
    tile = R * 512
    cases = [np.zeros(tile, np.uint8),
             g.integers(0, 16, tile).astype(np.uint8),
             (g.integers(0, 4, tile) + 4).astype(np.uint8),
             g.integers(0, 256, tile).astype(np.uint8),
             np.concatenate([g.integers(0, 2, tile // 2),
                             g.integers(0, 64, tile // 2)]).astype(np.uint8),
             np.zeros(tile - 1, np.uint8)]
    cases[1][::129] = 15
    for d in cases:
        tpu = fl_dense_pallas.host_probe_uniform_b(d, R)
        port = k.host_probe_uniform_b(d, 128, R)
        if tpu is not None:
            assert port == tpu
        fmax = d[: d.size // 128 * 128].reshape(-1, 128).max(1)
        widths = np.maximum(1, np.ceil(np.log2(fmax.astype(float) + 1)))
        uniform = d.size >= tile and (widths == widths[0]).all()
        assert (port is not None) == bool(uniform)


def test_wrappers_reject_bad_arguments():
    x = torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(ValueError):
        k.frame_widths(x, 12)
    with pytest.raises(ValueError):
        k.frame_widths(x.to(torch.int32), 8)
    with pytest.raises(ValueError):
        k.frame_widths(x, 8, fb_expect=9)
    bits, _ = k.frame_widths(x, 8)
    offs = k.frame_offsets(bits, 100, 8)
    with pytest.raises(ValueError):
        k.pack(x, 8, bits=bits)                       # no offs
    with pytest.raises(ValueError):
        k.pack(x, 8, bits=bits, offs=offs, fb=1)      # both modes
    with pytest.raises(ValueError):
        k.unpack(x, 100, 8, bits=bits[:-1], offs=offs)
