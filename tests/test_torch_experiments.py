"""The PyTorch package's experiment entry points
(``fl_rl_compression_mpi_tpu_torch/experiments/``) against the JAX
scripts they port, loaded by ``tests/torch_exp_scripts.py`` and run in
interpret mode (exp33's ``make`` and exp6's ``copy_pallas`` pass no
``interpret=``, so they run under ``pltpu.force_tpu_interpret_mode()``):
exp21 and exp22's encode, decode and round-trip chain, exp30's encode,
host split and decode, exp33's rounds, exp6's copy, and exp38's
cursor-emit kernel, whose function is x + 1 (the copy probe's).  Then
each entry point's ``main`` on the CPU at its ``--smoke`` size.  Inputs
from numpy seeds; tolerance: exact (integer functions)."""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_exp_scripts
from fl_rl_compression_mpi_tpu_torch.experiments import (
    exp6_r2_tuning, exp21_tile_packed, exp22_tile_packed2, exp30_rl_starts,
    exp33_round_latency)
from fl_rl_compression_mpi_tpu_torch.ops import copy_probe_cuda


def _words(seed: int, nrows: int) -> np.ndarray:
    """u32 words of width 1 in the first half of the rows, width 4 after,
    so that 16-row tiles reach depths 3 and 1."""
    g = np.random.default_rng(seed)
    b = g.integers(0, 16, nrows * 512, np.uint8)
    b[:nrows * 256] &= 1
    return b.view(np.uint32)


@pytest.mark.parametrize("port,name", [
    (exp21_tile_packed, "exp21_tile_packed"),
    (exp22_tile_packed2, "exp22_tile_packed2")])
def test_tile_packed_entry_points_match_the_script(port, name):
    jax_mod = torch_exp_scripts.load(name)
    R, nrows = 16, 64
    w = _words(3, nrows)
    jout = jax_mod.enc_packed(R, nrows)(jnp.asarray(w))
    got = port.enc_packed(R, nrows)(torch.from_numpy(w.view(np.int32)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jout[0]))
    if name == "exp21_tile_packed":
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(jout[2]))
        rows = int(got[2][-1])
    else:
        assert len(got) == 2 and len(jout) == 2
        rows = None
    # the halves are depth 3 then depth 1: 2 + 2 rows, then 8 + 8
    keep = (np.arange(20) if rows is not None else
            np.concatenate([[0, 1, 16, 17], np.arange(32, 40),
                            np.arange(48, 56)]))
    assert rows in (None, 20)
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32)[keep],
                                  np.asarray(jout[1])[keep])
    dec = port.dec_packed(R, nrows)(*got)
    jdec = jax_mod.dec_packed(R, nrows)(*jout)
    np.testing.assert_array_equal(dec.numpy().view(np.uint32),
                                  np.asarray(jdec))
    chain = port.make_packed_rt(R, nrows)
    out = chain(torch.from_numpy(w.view(np.int32)), 2)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), w)


def test_rl_starts_entry_points_match_the_script():
    jax_mod = torch_exp_scripts.load("exp30_rl_starts")
    rows = 128
    n = rows * 128 - 13
    host = exp30_rl_starts.gen(7, n, "cap")
    np.testing.assert_array_equal(host, jax_mod.gen(7, n, "cap"))
    buf = np.zeros(rows * 128, np.uint8)
    buf[:n] = host
    jpacked, jtotal = jax_mod.rl_encode_v2(
        jnp.asarray(buf.reshape(rows, 128)), jnp.int32(n), tile_rows=8)
    jtotal = int(jtotal)
    packed, total = exp30_rl_starts.rl_encode_v2(
        torch.from_numpy(buf.reshape(rows, 128)), n)
    assert int(total) == jtotal
    np.testing.assert_array_equal(packed.numpy()[:jtotal],
                                  np.asarray(jpacked)[:jtotal])
    for a, b in zip(exp30_rl_starts.split_v2_numpy(packed.numpy(), jtotal, n),
                    jax_mod.split_v2_numpy(np.asarray(jpacked), jtotal, n)):
        np.testing.assert_array_equal(a, b)
    jout = np.asarray(jax_mod.rl_decode_packed_v2(
        jpacked, jnp.int32(jtotal), rows)).reshape(-1)[:n]
    out = exp30_rl_starts.rl_decode_packed_v2(packed, total, n)
    np.testing.assert_array_equal(out.numpy(), jout)
    np.testing.assert_array_equal(out.numpy(), host)


@pytest.mark.parametrize("R,rows_total,parts", [(8, 16, 2), (8, 16, 1),
                                                (16, 32, 4)])
def test_rounds_match_the_script(R, rows_total, parts):
    jax_mod = torch_exp_scripts.load("exp33_round_latency")
    x = np.random.default_rng(R + parts).integers(
        0, 1 << 30, (rows_total, 128), np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_mod.make(R, rows_total, parts)(
            jnp.asarray(x), 1))
    chain = exp33_round_latency.make(R, rows_total, parts)
    got = chain(torch.from_numpy(x), 1)
    np.testing.assert_array_equal(got.numpy(), want)
    z = x.astype(np.int64)
    for _ in range(2 * exp33_round_latency.D):
        z = (z * 3 + np.roll(z, 1, 1)) & 0xFFFFFFFF
    np.testing.assert_array_equal(
        chain(torch.from_numpy(x), 2).numpy(),
        z.astype(np.uint32).view(np.int32))


def test_rounds_refuse_a_ragged_split():
    with pytest.raises(ValueError):
        exp33_round_latency.make(12, 24, 1)
    with pytest.raises(ValueError):
        exp33_round_latency.make(8, 20, 1)


@pytest.mark.parametrize("tile_r,tiles", [(8, 1), (16, 4)])
def test_copy_matches_the_script(tile_r, tiles):
    jax_mod = torch_exp_scripts.load_exp6_copy()
    nw = tile_r * 128 * tiles
    w = np.random.default_rng(tile_r).integers(0, 1 << 32, nw,
                                               dtype=np.uint64)
    w = w.astype(np.uint32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_mod.copy_pallas(jnp.asarray(w), tile_r=tile_r))
    got = exp6_r2_tuning.copy_words(torch.from_numpy(w.view(np.int32)))
    assert got.shape == want.shape == (nw // 128, 128)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("subs", [1, 4])
def test_exp38_cursor_emit_is_the_copy_probe(subs):
    """exp38's make_ident stages x + 1, not the identity: the copy probe's
    function (add_one_ref), not a kernel of its own."""
    jax_mod = torch_exp_scripts.load("exp38_step_overhead")
    rows = 64
    x = np.random.default_rng(subs).integers(0, 1 << 32, (rows, 128),
                                             dtype=np.uint64)
    x = x.astype(np.uint32)
    want = np.asarray(jax_mod.make_ident(16, rows, subs)(jnp.asarray(x)))
    got = copy_probe_cuda.add_one_ref(torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("port", [exp21_tile_packed, exp22_tile_packed2,
                                  exp30_rl_starts, exp33_round_latency,
                                  exp6_r2_tuning])
def test_main_runs_on_the_cpu(port):
    """``main`` at its smoke size on the plain versions: exit 0, the
    device record first, and every parity or round trip it checks true."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = port.main(["--device", "cpu", "--smoke"])
    lines = buf.getvalue().strip().splitlines()
    assert rc == 0, lines[-5:]
    assert json.loads(lines[0]) == {"device": "cpu", "power_limit": None}
    if port is not exp33_round_latency:
        last = json.loads(lines[-1])
        oks = {k: v for k, v in last.items()
               if "parity" in k or k.endswith("_ok")}
        assert oks and all(oks.values()), last
