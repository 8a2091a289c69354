"""The copy-ceiling probe of the PyTorch package (``ops/copy_probe_cuda.py``)
against the JAX bench's Pallas kernel ``_cp``, restated here exactly as
``bench.py:417-429`` builds it inside ``main`` and run in interpret mode.
Inputs: (2048·k, 128) u32 words from a numpy seed, a third of them within 8
of 2^32 − 1, chained three times.  Tolerance: exact (integer arithmetic)."""

import os
import re

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fl_rl_compression_mpi_tpu_torch.ops import _build
from fl_rl_compression_mpi_tpu_torch.ops import copy_probe_cuda as cp


def _cp_kernel(x_ref, o_ref):
    o_ref[...] = x_ref[...] + jnp.uint32(1)


def _cp(w, nrows_c):
    return pl.pallas_call(
        _cp_kernel, grid=(nrows_c // 2048,),
        in_specs=[pl.BlockSpec((2048, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((2048, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((nrows_c, 128), jnp.uint32),
        interpret=jax.default_backend() != "tpu",
    )(w.reshape(nrows_c, 128))


def _words(seed: int, nwords: int) -> np.ndarray:
    g = np.random.default_rng(seed)
    w = g.integers(0, 1 << 32, nwords, dtype=np.uint64).astype(np.uint32)
    top = g.integers(0, 8, nwords // 3, dtype=np.uint64).astype(np.uint32)
    w[: nwords // 3] = np.uint32(0xFFFFFFFF) - top       # wrap within 3 steps
    return g.permutation(w)


@pytest.mark.parametrize("k", [1, 2])
def test_add_one_ref_matches_pallas_cp_chained(k):
    nrows = 2048 * k
    w = _words(k, nrows * 128)
    want = jnp.asarray(w)
    got = torch.from_numpy(w.view(np.int32))
    for _ in range(3):
        want = _cp(want, nrows).reshape(-1)
        got = cp.add_one_ref(got)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))


@pytest.mark.parametrize("nwords", [0, 1, 3, 4, 5, 2048 * 128 + 7])
def test_add_one_on_cpu_runs_the_plain_version(nwords):
    cp.reset_launches()
    w = _words(nwords, nwords)
    x = torch.from_numpy(w.view(np.int32))
    got = cp.add_one(x)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  w + np.uint32(1))
    assert cp.LAUNCHES["copy_probe"] == 0


def test_add_one_on_an_offset_view():
    w = _words(9, 4099)
    x = torch.from_numpy(w.view(np.int32))[1:4097]
    np.testing.assert_array_equal(cp.add_one(x).numpy().view(np.uint32),
                                  w[1:4097] + np.uint32(1))


@pytest.mark.parametrize("bad", [
    torch.zeros(8, dtype=torch.uint8),
    torch.zeros(8, dtype=torch.int64),
    torch.zeros((2, 4), dtype=torch.int32),
    torch.zeros(8, dtype=torch.int32)[::2],
])
def test_add_one_refuses_other_tensors(bad):
    with pytest.raises(ValueError):
        cp.add_one(bad)


def test_launcher_signature_matches_the_header():
    """The ctypes signature has as many arguments as the C prototype."""
    path = os.path.join(_build.CSRC_DIR, "copy_probe.cuh")
    with open(path) as f:
        proto = re.search(r"flrl_copy_probe\(([^)]*)\)", f.read()).group(1)
    _, argtypes = _build._SIGNATURES["flrl_copy_probe"]
    assert len(argtypes) == len(proto.split(","))
