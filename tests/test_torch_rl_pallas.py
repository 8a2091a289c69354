"""Plain PyTorch versions of the RL kernels against the TPU's Pallas
kernels #11 (``rl_encode_pallas`` + ``rl_split_packed``) and #12
(``_decode_impl`` via ``rl_decode_pallas`` and
``rl_decode_packed_pallas``), in interpret mode at 8-row tiles, as
``test_rl_pallas.py`` runs them.  Tolerance: byte equality throughout.

The port has one decode kernel for both TPU entry points: its encoder
writes counts and values directly, so there is no packed stream to decode.
The packed case below shows the plain decode equals the packed-stream
decode on the same input classes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_rl_compression_mpi_tpu.ops import rl_pallas
from fl_rl_compression_mpi_tpu_torch.ops import rl_cuda as k

R = 8
TILE = R * 128


def _pallas_cases():
    g = np.random.default_rng(21)
    return [
        ("few-runs", g.integers(0, 4, 2000, np.uint8)),
        ("cap-runs", np.repeat(g.integers(0, 8, 10, np.uint8),
                               300)[:2500].copy()),
        ("dense-tail", g.integers(0, 256, TILE + 77, np.uint8)),
        ("const-cut", np.concatenate([g.integers(0, 3, 300, np.uint8),
                                      np.full(TILE + 700, 42, np.uint8)])),
    ]


def _plain(data):
    x = torch.from_numpy(data)
    n = x.numel()
    values, counts, _ = k.encode_chunk(x)
    out = k.expand(counts, values, k.run_offsets(counts), n)
    return counts.numpy(), values.numpy(), out.numpy()


@pytest.mark.parametrize("name,data", _pallas_cases(),
                         ids=[c[0] for c in _pallas_cases()])
def test_plain_versions_match_pallas(name, data):
    n = data.size
    npad = -(-n // TILE) * TILE
    buf = np.zeros(npad, np.uint8)
    buf[:n] = data
    packed, total = rl_pallas.rl_encode_pallas(
        jnp.asarray(buf.reshape(-1, 128)), jnp.int32(n), tile_rows=R,
        sub_rows=R)
    pc, pv = rl_pallas.rl_split_packed(packed, total, jnp.int32(n))
    runs = int(total)
    counts, values, out = _plain(data)
    np.testing.assert_array_equal(counts, np.asarray(pc)[:runs])
    np.testing.assert_array_equal(values, np.asarray(pv)[:runs])
    np.testing.assert_array_equal(out, data)

    rcap = -(-runs // 128) * 128
    cbuf = np.zeros(rcap, np.uint8)
    cbuf[:runs] = counts
    vbuf = np.zeros(rcap, np.uint8)
    vbuf[:runs] = values
    dec = rl_pallas.rl_decode_pallas(
        jnp.asarray(cbuf), jnp.asarray(vbuf), jnp.int32(runs), npad // 128,
        tile_rows=R, sub_rows=R)
    np.testing.assert_array_equal(np.asarray(dec).reshape(-1)[:n], out)
    dec_packed = rl_pallas.rl_decode_packed_pallas(
        packed, total, npad // 128, tile_rows=R, sub_rows=R)
    np.testing.assert_array_equal(np.asarray(dec_packed).reshape(-1)[:n],
                                  out)
