"""The RL encode's starts mode and its decode in the PyTorch package
(``rl_cuda.encode_starts``, ``rl_torch.starts_counts`` and
``decode_starts``) against the kernel they replace, ``rl_encode_v2`` of
``experiments/exp30_rl_starts.py`` (loaded by ``tests/torch_exp_scripts.py``,
run in interpret mode at 8-row tiles with both ``mxu_psum`` values), its
``split_v2_numpy`` and ``rl_decode_packed_v2``, and ``rl_numpy``.  Inputs
are the script's own kinds (``long``, ``short``, ``cap``, ``const``,
``rand``) from numpy seeds, in 256 rows of 128 bytes less a ragged tail
(the JAX decode takes whole 128-row tiles).  Tolerance: exact."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_exp_scripts
from fl_rl_compression_mpi_tpu_torch.ops import _build, rl_cuda, rl_numpy
from fl_rl_compression_mpi_tpu_torch.ops import rl_torch

KINDS = ("long", "short", "cap", "const", "rand")
ROWS = 256
N = ROWS * 128 - 77


def _script():
    return torch_exp_scripts.load("exp30_rl_starts")


def _stream(kind: str, n: int = N) -> np.ndarray:
    return _script().gen(KINDS.index(kind), n, kind)


def _jax_encode(host: np.ndarray, mxu: bool):
    buf = np.zeros(ROWS * 128, np.uint8)
    buf[:host.size] = host
    packed, total = _script().rl_encode_v2(
        jnp.asarray(buf.reshape(ROWS, 128)), jnp.int32(host.size),
        tile_rows=8, mxu_psum=mxu)
    return packed, int(total)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_encode_starts_matches_the_jax_kernel(kind, mxu):
    host = _stream(kind)
    jpacked, jtotal = _jax_encode(host, mxu)
    packed, total = rl_cuda.encode_starts(torch.from_numpy(host))
    assert total.dtype == torch.int64 and total.tolist() == [jtotal]
    assert packed.dtype == torch.int32 and packed.numel() == N
    np.testing.assert_array_equal(packed.numpy()[:jtotal],
                                  np.asarray(jpacked)[:jtotal])
    # the script's host split, on both streams, is rl_numpy's encode
    counts, values = rl_numpy.encode(host)
    for p in (packed.numpy(), np.asarray(jpacked)):
        c, v = _script().split_v2_numpy(p, jtotal, N)
        np.testing.assert_array_equal(c, counts)
        np.testing.assert_array_equal(v, values)
    c, v = rl_torch.starts_counts(packed, total, N)
    np.testing.assert_array_equal(c.numpy()[:jtotal], counts)
    np.testing.assert_array_equal(v.numpy()[:jtotal], values)
    assert not c[jtotal:].any()


@pytest.mark.parametrize("kind", ["long", "cap"])
def test_decode_starts_matches_the_jax_decode(kind):
    host = _stream(kind)
    jpacked, jtotal = _jax_encode(host, False)
    jout = np.asarray(_script().rl_decode_packed_v2(
        jpacked, jnp.int32(jtotal), ROWS)).reshape(-1)[:N]
    np.testing.assert_array_equal(jout, host)
    packed, total = rl_cuda.encode_starts(torch.from_numpy(host))
    got = rl_torch.decode_starts(packed, total, N)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), jout)
    # the JAX encode's stream decodes the same through the port
    got = rl_torch.decode_starts(torch.from_numpy(np.array(jpacked)),
                                 jtotal, N)
    np.testing.assert_array_equal(got.numpy(), host)


@pytest.mark.parametrize("n", [0, 1, 2, 254, 255, 256, 511, 4096 + 3,
                               70_000])
def test_round_trip_and_encode_against_rl_numpy(n):
    g = np.random.default_rng(n)
    host = np.repeat(g.integers(0, 3, n), g.integers(1, 700, n))[:n]
    host = host.astype(np.uint8)
    packed, total = rl_cuda.encode_starts(torch.from_numpy(host))
    counts, values = rl_numpy.encode(host)
    assert int(total) == counts.size
    p = packed.numpy()[:counts.size].astype(np.int64)
    np.testing.assert_array_equal(p & 0xFF, values)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]) if n else []
    np.testing.assert_array_equal(p >> 8, np.asarray(starts) % 256)
    for t in (total, int(total)):
        np.testing.assert_array_equal(
            rl_torch.decode_starts(packed, t, n).numpy(), host)


def test_entries_past_total_are_ignored():
    host = _stream("short", 5000)
    packed, total = rl_cuda.encode_starts(torch.from_numpy(host))
    junk = packed.clone()
    junk[int(total):] = torch.from_numpy(np.random.default_rng(1).integers(
        -(1 << 31), 1 << 31, junk.numel() - int(total)).astype(np.int32))
    np.testing.assert_array_equal(
        rl_torch.decode_starts(junk, total, 5000).numpy(), host)


def test_on_cpu_no_launch():
    rl_cuda.reset_launches()
    host = _stream("long", 3000)
    packed, total = rl_cuda.encode_starts(torch.from_numpy(host))
    rl_torch.decode_starts(packed, total, 3000)
    assert rl_cuda.LAUNCHES["rl_encode_starts"] == 0


@pytest.mark.parametrize("bad", [
    torch.zeros(8, dtype=torch.int32),
    torch.zeros((2, 4), dtype=torch.uint8),
    torch.zeros(8, dtype=torch.uint8)[::2],
])
def test_encode_starts_refuses_other_tensors(bad):
    with pytest.raises(ValueError):
        rl_cuda.encode_starts(bad)


def test_launcher_signature_matches_the_header():
    with open(os.path.join(_build.CSRC_DIR, "rl.cuh")) as f:
        proto = re.search(r"flrl_rl_encode_starts\(([^)]*)\)",
                          f.read()).group(1)
    _, argtypes = _build._SIGNATURES["flrl_rl_encode_starts"]
    assert len(argtypes) == len(proto.split(","))
