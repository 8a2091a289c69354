"""Constant-stream kernels #5/#6 (``ops/fl_constant_cuda.py``): the plain
PyTorch versions against ``fl_numpy``, the host closed form and the TPU's
Pallas kernels (interpret mode, 8-row tiles, as ``test_distributed.py``
runs them); the flags; the wrappers' checks.  Tolerance: byte equality
throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_rl_compression_mpi_tpu.ops import fl_dense_pallas, fl_numpy
from fl_rl_compression_mpi_tpu_torch.ops import fl_constant_cuda as ck
from fl_rl_compression_mpi_tpu_torch.ops import fl_torch

R = 8                      # Pallas tile rows in interpret mode
TILE = R * 512

# (cbyte, n): every valid class.  A nonzero constant needs n % 128 == 0;
# zero takes any tail.
CASES = ([(c, 128 * 75) for c in (0, 1, 3, 15, 255)]
         + [(0, 128 * 75 + t) for t in (1, 77, 127)]
         + [(2, 128), (9, TILE * 3), (0, 1)])
IDS = [f"c{c}-n{n}" for c, n in CASES]


def _fb(c):
    return max(1, c.bit_length())


def _enc(data, c):
    return ck.encode_constant(torch.from_numpy(data), c, _fb(c))


@pytest.mark.parametrize("c,n", CASES, ids=IDS)
def test_twins_equal_fl_numpy_and_the_closed_form(c, n):
    data = np.full(n, c, np.uint8)
    bits, values, flag = _enc(data, c)
    want_b, want_v = fl_numpy.encode(data)
    np.testing.assert_array_equal(bits.numpy(), want_b)
    np.testing.assert_array_equal(values.numpy(), want_v)
    cb, cv = fl_torch._constant_container(c, n, 128)
    np.testing.assert_array_equal(values.numpy(), cv)
    np.testing.assert_array_equal(bits.numpy(), cb)
    assert int(flag) == 0
    out, dflag = ck.decode_constant(values, values.numel(), c, _fb(c), n)
    np.testing.assert_array_equal(out.numpy(), data)
    assert int(dflag) == 0


@pytest.mark.parametrize("c,n", CASES, ids=IDS)
def test_encode_flag_trips_on_a_flipped_real_byte(c, n):
    data = np.full(n, c, np.uint8)
    for pos in sorted({0, n // 2, n - 1}):
        bad = data.copy()
        bad[pos] ^= 0x40
        assert int(_enc(bad, c)[2]) == 1, pos


@pytest.mark.parametrize("c,n", CASES, ids=IDS)
def test_decode_flag_reads_exactly_values_size_bytes(c, n):
    """A flipped payload byte trips the flag, the straddling tail word's
    real bytes included; a byte past ``values_size`` (the tail word's pad)
    does not."""
    fb = _fb(c)
    _, values, _ = _enc(np.full(n, c, np.uint8), c)
    vsz = values.numel()
    buf = torch.zeros(-(-vsz // 4) * 4 + 4, dtype=torch.uint8)
    buf[:vsz] = values
    buf[vsz:] = 0xA5                 # pad bytes that are not the pattern
    assert int(ck.decode_constant(buf, vsz, c, fb, n)[1]) == 0
    for pos in sorted({0, vsz // 2, vsz - 1}):
        bad = buf.clone()
        bad[pos] ^= 0x10
        assert int(ck.decode_constant(bad, vsz, c, fb, n)[1]) == 1, pos


def _padded_words(data: np.ndarray) -> np.ndarray:
    npad = max(TILE, -(-data.size // TILE) * TILE)
    buf = np.zeros(npad, np.uint8)
    buf[: data.size] = data
    return buf.view(np.uint32)


@pytest.mark.parametrize("flip", [None, 0, "middle", "last"])
@pytest.mark.parametrize("c,n", CASES, ids=IDS)
def test_twins_match_pallas(c, n, flip):
    """#5 fl_encode_dense_constant_pallas and #6
    fl_decode_dense_constant_pallas on the same bytes: widths, payload,
    decoded bytes and both flags."""
    fb = _fb(c)
    data = np.full(n, c, np.uint8)
    if flip is not None:
        data[{0: 0, "middle": n // 2, "last": n - 1}[flip]] ^= 0x40
    frames = -(-n // 128)
    b2, dense, flag = fl_dense_pallas.fl_encode_dense_constant_pallas(
        jnp.asarray(_padded_words(data)), jnp.int32(frames), c, fb,
        tile_r=R)
    bits, values, tflag = _enc(data, c)
    assert int(flag) == int(tflag) == (0 if flip is None else 1)
    if flip is not None:
        return
    vsz = values.numel()
    np.testing.assert_array_equal(
        np.asarray(b2).reshape(-1)[:frames], bits.numpy())
    np.testing.assert_array_equal(
        np.asarray(dense).reshape(-1).view(np.uint8)[:vsz], values.numpy())
    rows_out = -(-max(n, 1) // TILE) * R
    for corrupt in (None, 0, vsz - 1):
        payload = np.asarray(dense).copy()
        flat = payload.reshape(-1).view(np.uint8)
        flat[vsz:vsz + 3] = 0xA5     # pad of the straddling tail word
        if corrupt is not None:
            flat[corrupt] ^= 0x10
        out, dflag = fl_dense_pallas.fl_decode_dense_constant_pallas(
            jnp.asarray(payload), jnp.int32(vsz), c, fb, rows_out, tile_r=R)
        t_out, t_flag = ck.decode_constant(
            torch.from_numpy(flat.copy()), vsz, c, fb, n)
        assert int(dflag) == int(t_flag) == (corrupt is not None)
        np.testing.assert_array_equal(
            np.asarray(out).reshape(-1).view(np.uint8)[:n], t_out.numpy())


def test_pattern_byte_is_the_payload_words_byte():
    for c in range(256):
        fb = _fb(c)
        if fb not in ck.FAST_BS:
            continue
        word = fl_dense_pallas.const_payload_word(c, fb)
        assert word == ck.pattern_byte(c, fb) * 0x01010101


@pytest.mark.parametrize("head", [0, 7, 15, 200])
def test_host_probe_matches_jax(head):
    n = TILE * 2 + (0 if head != 200 else 77)
    for data in (np.full(n, head, np.uint8),
                 np.concatenate([np.full(TILE - 1, head, np.uint8),
                                 np.full(n - TILE + 1, head ^ 1,
                                         np.uint8)])):
        assert ck.host_probe_constant(data, n, tile_r=R) == \
            fl_dense_pallas.host_probe_constant(data, n, tile_r=R)
    assert ck.host_probe_constant(np.zeros(TILE - 1, np.uint8), TILE - 1,
                                  tile_r=R) is None


def test_wrappers_reject_invalid_speculation():
    x = torch.full((128 * 3 + 1,), 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="n % 128"):
        ck.encode_constant(x, 3, 2)              # partial tail, c != 0
    with pytest.raises(ValueError, match="fb = max"):
        ck.encode_constant(x[:128], 3, 4)        # fb is not c's width
    with pytest.raises(ValueError, match="fb = max"):
        ck.encode_constant(x[:128], 5, 3)        # width 3 is not in FAST_BS
    with pytest.raises(ValueError, match="outside"):
        ck.decode_constant(torch.zeros(4, dtype=torch.uint8), 5, 0, 1, 40)
    with pytest.raises(ValueError, match="no kernel"):
        ck.encode_constant(x[:128].to("meta"), 3, 2)


def test_empty_stream_launches_nothing():
    ck.reset_launches()
    bits, values, flag = ck.encode_constant(
        torch.zeros(0, dtype=torch.uint8), 0, 1)
    assert bits.numel() == values.numel() == int(flag) == 0
    assert ck.LAUNCHES == {"fl_const_encode": 0, "fl_const_decode": 0}
