"""Plain PyTorch versions of the dense kernels against the TPU's Pallas
kernels #1-#4 (interpret mode, 8-row tiles), as ``test_fl_dense.py``
runs them.  Tolerance: byte equality throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_rl_compression_mpi_tpu.ops import fl_dense_pallas
from fl_rl_compression_mpi_tpu_torch.ops import fl_dense_cuda as k


R = 8
TILE = R * 512


def _pallas_cases():
    g = np.random.default_rng(11)
    return [
        ("w4-tail", g.integers(0, 16, 5000, np.uint8)),
        ("all-widths", np.concatenate(
            [g.integers(0, 1 << b, 128).astype(np.uint8)
             for b in range(1, 9)] * 3)),
        ("tiny-tail", g.integers(0, 5, 137).astype(np.uint8)),
        ("cross-tile", g.integers(0, 64, TILE * 2 + 77, np.uint8)),
    ]


def _padded_words(data: np.ndarray) -> np.ndarray:
    npad = max(TILE, -(-data.size // TILE) * TILE)
    buf = np.zeros(npad, np.uint8)
    buf[: data.size] = data
    return buf.view(np.uint32)


@pytest.mark.parametrize("name,data", _pallas_cases(),
                         ids=[c[0] for c in _pallas_cases()])
def test_general_kernels_match_pallas(name, data):
    """#1 fl_encode_dense_pallas and #2 fl_decode_dense_pallas."""
    n = data.size
    frames = -(-n // 128)
    bits2d, dense, _, woffs = fl_dense_pallas.fl_encode_dense_pallas(
        jnp.asarray(_padded_words(data)), jnp.int32(frames), tile_r=R)
    x = torch.from_numpy(data)
    bits, _ = k.frame_widths(x, 128)
    offs = k.frame_offsets(bits, n, 128)
    values = k.pack(x, 128, bits=bits, offs=offs)
    out = k.unpack(values, n, 128, bits=bits, offs=offs)
    vsz = int(offs[-1])
    np.testing.assert_array_equal(
        np.asarray(bits2d).reshape(-1)[:frames], bits.numpy())
    np.testing.assert_array_equal(
        np.asarray(dense).view(np.uint8)[:vsz], values.numpy())
    dec = fl_dense_pallas.fl_decode_dense_pallas(
        jnp.asarray(dense).reshape(-1, 128), bits2d, woffs,
        jnp.int32(frames), tile_r=R)
    np.testing.assert_array_equal(
        np.asarray(dec).reshape(-1).view(np.uint8)[:n], out.numpy())


@pytest.mark.parametrize("fb,lo,hi", [(1, 0, 2), (2, 0, 4), (4, 0, 16),
                                      (8, 128, 256)])
def test_uniform_kernels_match_pallas(fb, lo, hi):
    """#3 fl_encode_dense_uniform_pallas and #4
    fl_decode_dense_uniform_pallas, and the flag on a uniform stream."""
    g = np.random.default_rng(43 + fb)
    data = g.integers(lo, hi, TILE * 2).astype(np.uint8)
    data[::128] = hi - 1                 # pin every frame's width
    n = data.size
    x = torch.from_numpy(data)
    b2, dense, flag = fl_dense_pallas.fl_encode_dense_uniform_pallas(
        jnp.asarray(data.view(np.uint32)), jnp.int32(n // 128), fb, tile_r=R)
    bits, pflag = k.frame_widths(x, 128, fb_expect=fb)
    assert int(flag) == 0 and int(pflag) == 0
    np.testing.assert_array_equal(np.asarray(b2).reshape(-1), bits.numpy())
    values = k.pack(x, 128, fb=fb)
    np.testing.assert_array_equal(
        np.asarray(dense).reshape(-1).view(np.uint8)[:values.numel()],
        values.numpy())
    out = fl_dense_pallas.fl_decode_dense_uniform_pallas(
        np.asarray(dense).reshape(-1, 128), fb, n // 512, tile_r=R)
    np.testing.assert_array_equal(
        np.asarray(out).reshape(-1).view(np.uint8),
        k.unpack(values, n, 128, fb=fb).numpy())


def test_uniform_flag_matches_pallas_on_mixed_stream():
    g = np.random.default_rng(44)
    data = g.integers(0, 16, TILE).astype(np.uint8)
    data[0] = 255
    _, _, flag = fl_dense_pallas.fl_encode_dense_uniform_pallas(
        jnp.asarray(data.view(np.uint32)), jnp.int32(data.size // 128), 4,
        tile_r=R)
    _, pflag = k.frame_widths(torch.from_numpy(data), 128, fb_expect=4)
    assert int(flag) != 0 and int(pflag) != 0
