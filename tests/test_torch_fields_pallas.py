"""Plain PyTorch versions of the field kernels against the TPU's Pallas
kernels #7-#10 (``ops/fl_pallas.py``) in interpret mode, at 16-row tiles.
Tolerance: byte equality throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_rl_compression_mpi_tpu.ops import fl_pallas
from fl_rl_compression_mpi_tpu_torch.ops import fl_fields_cuda as fk

TR = 16
WORDS = 2 * TR * 128                  # two tiles


def _case(L, top, seed):
    """Two tiles of words: frames of random widths 1..top, then a tail of
    zero bytes past n (the encoders' input contract)."""
    g = np.random.default_rng(seed)
    n = WORDS * 4 - L - 5
    frames = -(-n // L)
    widths = g.integers(1, top + 1, frames)
    masks = ((1 << widths) - 1).astype(np.uint8)
    data = g.integers(0, 256, (frames, L), np.uint8) & masks[:, None]
    data[:, 0] = masks
    buf = np.zeros(WORDS * 4, np.uint8)
    buf[:n] = data.reshape(-1)[:n]
    return buf.view(np.uint32), n


def _t(a):
    return torch.from_numpy(np.array(a).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("L", [8, 64, 128, 512])
@pytest.mark.parametrize("top", [4, 8], ids=["widths<=4", "mixed"])
def test_twins_match_pallas_field_kernels(L, top):
    words, n = _case(L, top, L + top)
    nj = jnp.int32(n)
    # #7 fl_encode_fields_pallas and #8 fl_decode_fields_pallas
    b2d, f = fl_pallas.fl_encode_fields_pallas(jnp.asarray(words), nj, L,
                                               tile_r=TR)
    bits, ours = fk.encode_fields(_t(words), L)
    np.testing.assert_array_equal(np.asarray(b2d).reshape(-1), bits.numpy())
    np.testing.assert_array_equal(np.asarray(f), _u32(ours))
    out = fl_pallas.fl_decode_fields_pallas(f, b2d, nj, L, tile_r=TR)
    np.testing.assert_array_equal(np.asarray(out),
                                  _u32(fk.decode_fields(ours, bits, L)))
    np.testing.assert_array_equal(np.asarray(out), words)
    # #9 fl_encode_fields_packed_pallas: its words are valid only where
    # every width is <= 4; the widths always are
    b2p, p = fl_pallas.fl_encode_fields_packed_pallas(jnp.asarray(words), nj,
                                                      L, tile_r=TR)
    bits2, packed = fk.encode_fields(_t(words), L, TR)
    np.testing.assert_array_equal(np.asarray(b2p).reshape(-1), bits2.numpy())
    if top <= 4:
        np.testing.assert_array_equal(np.asarray(p), _u32(packed))
    # #10 fl_decode_fields_packed_pallas, on the same slots
    outp = fl_pallas.fl_decode_fields_packed_pallas(p, b2p, nj, L,
                                                    tile_r=TR)
    np.testing.assert_array_equal(
        np.asarray(outp), _u32(fk.decode_fields(_t(np.asarray(p)), bits, L,
                                                TR)))
    if top <= 4:
        np.testing.assert_array_equal(np.asarray(outp), words)
