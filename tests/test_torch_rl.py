"""The PyTorch package's RL codec on the CPU: the plain versions of the RL
kernels (``rl_cuda``) and the dispatch (``rl_torch``) against
``rl_numpy``, the JAX package's ``rl_jax`` and the golden container.
Tolerance: byte equality throughout."""

import os

import numpy as np
import pytest
import torch

from fuzz_battery import battery
from test_rl_pallas import _cases
from fl_rl_compression_mpi_tpu import container
from fl_rl_compression_mpi_tpu.models.registry import CODECS as JAX_CODECS
from fl_rl_compression_mpi_tpu.ops import rl_jax, rl_numpy
from fl_rl_compression_mpi_tpu_torch.models import registry
from fl_rl_compression_mpi_tpu_torch.ops import fl_torch, rl_cuda, rl_torch

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BATTERY = battery()
CASES = _cases()
INPUTS = ([(f"battery{i}", d) for i, d in enumerate(BATTERY)]
          + [(name, d) for name, d in CASES])


def _plain_encode(data, prev=-1, d0=0):
    """The encode kernels' plain versions, in the order the dispatch runs
    them, on one chunk."""
    x = torch.from_numpy(np.ascontiguousarray(data))
    n = x.numel()
    summ = rl_cuda.piece_tiles_ref(x, prev)
    tstart, offs = rl_cuda.piece_offsets_ref(summ, n, d0)
    values, starts8 = rl_cuda.compact_ref(x, prev, tstart, offs)
    assert values.numel() == int(offs[-1])
    counts = rl_cuda.piece_counts_ref(starts8, n)
    return counts.numpy(), values.numpy(), int(tstart[-1])


def _plain_decode(counts, values):
    c, v = torch.from_numpy(counts), torch.from_numpy(values)
    offs = rl_cuda.run_offsets_ref(c)
    out = rl_cuda.expand_ref(c, v, offs, int(offs[-1]))
    assert out.numel() == int(offs[-1])
    return out.numpy()


def _enc(data):
    return rl_torch.encode(data, device="cpu")


def _dec(counts, values):
    return rl_torch.decode(counts, values, device="cpu")


@pytest.mark.parametrize("name,data", INPUTS, ids=[n for n, _ in INPUTS])
def test_plain_kernels_match_rl_numpy(name, data):
    counts, values, _ = _plain_encode(data)
    cg, vg = rl_numpy.encode(data)
    np.testing.assert_array_equal(counts, cg)
    np.testing.assert_array_equal(values, vg)
    np.testing.assert_array_equal(_plain_decode(cg, vg), data)


@pytest.mark.parametrize("name,data", INPUTS, ids=[n for n, _ in INPUTS])
def test_dispatch_matches_rl_jax(name, data):
    counts, values = _enc(data)
    jc, jv = rl_jax.encode(data)
    np.testing.assert_array_equal(counts, jc)
    np.testing.assert_array_equal(values, jv)
    np.testing.assert_array_equal(_dec(counts, values),
                                  rl_jax.decode(jc, jv))


def test_golden_container_reproduced_and_decoded(tmp_path):
    data = np.fromfile(os.path.join(GOLDEN, "input.bin"), np.uint8)
    out = str(tmp_path / "o.rl")
    container.save_rl(out, container.RLCompressed(*_enc(data), data.size))
    with open(out, "rb") as a, open(os.path.join(GOLDEN, "input.rl"),
                                    "rb") as b:
        assert a.read() == b.read()
    ref = container.load_rl(os.path.join(GOLDEN, "input.rl"))
    np.testing.assert_array_equal(_dec(ref.counts, ref.values), data)


@pytest.mark.parametrize("n", [1, 254, 255, 256, 510, 255 * 300 + 17])
@pytest.mark.parametrize("c", [0, 7, 255])
def test_constant_closed_forms_match_rl_jax(n, c):
    data = np.full(n, c, np.uint8)
    counts, values = _enc(data)
    jc, jv = rl_jax.encode(data)
    np.testing.assert_array_equal(counts, jc)
    np.testing.assert_array_equal(values, jv)
    np.testing.assert_array_equal(_dec(counts, values), data)
    np.testing.assert_array_equal(_dec(counts, values),
                                  rl_jax.decode(jc, jv))


def _walk_stream():
    """Runs that put chunk boundaries mid-piece, at a distance ≡ 0 (mod
    255) from a run start and on a new value, for the caps below."""
    g = np.random.default_rng(5)
    lens = [700, 1, 255, 510, 3, 254, 256, 1200, 2, 765, 97]
    vals = g.integers(0, 4, len(lens)).astype(np.uint8)
    vals[1::2] = 9                          # neighbours always differ
    return np.concatenate([np.repeat(vals, lens),
                           g.integers(0, 3, 5000, np.uint8)])


CAPS = [100, 255, 256, 510, 700, 701, 4096, 5000]


@pytest.mark.parametrize("cap", CAPS)
def test_chunk_walk_equals_one_pass(cap, monkeypatch):
    data = _walk_stream()
    one_c, one_v = _enc(data)
    monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", cap)
    counts, values = _enc(data)
    np.testing.assert_array_equal(counts, one_c)
    np.testing.assert_array_equal(values, one_v)
    out = _dec(counts, values)
    np.testing.assert_array_equal(out, data)
    block_end = rl_torch._block_ends(counts)
    for r0, r1, o0, o1 in rl_torch._run_chunks(counts, block_end, cap):
        assert r1 > r0 and (o1 - o0 <= cap or r1 == r0 + 1)


def test_chunk_boundaries_fall_on_each_class():
    """The caps above do put chunk boundaries mid-piece, on a piece start
    inside a run and on a new value."""
    data = _walk_stream()
    counts, _ = rl_numpy.encode(data)
    starts = set(np.cumsum(counts.astype(np.int64)) - counts)
    natural = {0} | set(np.flatnonzero(data[1:] != data[:-1]) + 1)
    classes = set()
    for b in (b for cap in CAPS for b in range(cap, data.size, cap)):
        classes.add("new value" if b in natural
                    else "cap boundary" if b in starts else "mid-piece")
    assert classes == {"new value", "cap boundary", "mid-piece"}


def test_carry_in_matches_rl_numpy_on_the_whole_stream():
    """One chunk encoded with a carry-in yields the pieces the whole
    stream has there (the last count measured to the chunk's end)."""
    data = _walk_stream()
    whole_c, whole_v = rl_numpy.encode(data)
    starts = np.cumsum(whole_c.astype(np.int64)) - whole_c
    for cut in (700, 955, 1210, 1466, 2036):
        head = data[:cut]
        prev = int(head[-1])
        run = cut - 1
        while run > 0 and data[run - 1] == prev:
            run -= 1
        counts, values, run_start = _plain_encode(data[cut:], prev, cut - run)
        sel = starts >= cut
        np.testing.assert_array_equal(values, whole_v[sel])
        np.testing.assert_array_equal(counts, whole_c[sel])
        _, _, head_start = _plain_encode(head)
        assert head_start == run


@pytest.mark.parametrize("cap", [None, 3, 300])
def test_zero_count_containers(cap, monkeypatch):
    g = np.random.default_rng(8)
    counts = g.integers(0, 256, 2000).astype(np.uint8)
    counts[::3] = 0
    counts[-1] = 0
    values = g.integers(0, 256, 2000, np.uint8)
    if cap:
        monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", cap)
    # the sequential oracle and the native host codec; rl_numpy.decode
    # agrees while no zero count ends the container.  (rl_jax's XLA decode
    # places the values after an interior zero count wrongly, so it is not
    # the reference here.)
    want = rl_numpy.decode_seq(counts, values)
    np.testing.assert_array_equal(
        JAX_CODECS["rl-cpu"].decompress(
            container.RLCompressed(counts, values, 0)), want)
    live = np.flatnonzero(counts)[-1] + 1
    np.testing.assert_array_equal(
        rl_numpy.decode(counts[:live], values[:live]), want)
    np.testing.assert_array_equal(_dec(counts, values), want)
    np.testing.assert_array_equal(_plain_decode(counts, values), want)
    # all-zero counts decode to nothing
    assert _dec(np.zeros(5, np.uint8), values[:5]).size == 0


def test_decode_ignores_input_size_like_rl_jax(monkeypatch):
    monkeypatch.setattr(registry, "default_device",
                        lambda: torch.device("cpu"))
    data = _walk_stream()
    for size in (0, data.size - 1, data.size + 1000):
        comp = container.RLCompressed(*rl_numpy.encode(data), size)
        got = registry.CODECS["rl"].decompress(comp)
        np.testing.assert_array_equal(got, JAX_CODECS["rl"].decompress(comp))
        np.testing.assert_array_equal(got, data)


def test_decode_rejects_mismatched_lengths():
    with pytest.raises(ValueError, match="counts/values size mismatch"):
        _dec(np.ones(3, np.uint8), np.ones(2, np.uint8))


def test_wrappers_check_their_arguments():
    x = torch.zeros(10, dtype=torch.uint8)
    with pytest.raises(ValueError, match="prev"):
        rl_cuda.piece_tiles(x, 256)
    with pytest.raises(ValueError, match="summ"):
        rl_cuda.piece_offsets(torch.zeros(2, 3, dtype=torch.int64), 10)
    with pytest.raises(ValueError, match="pieces"):
        rl_cuda.piece_counts(torch.zeros(5, dtype=torch.uint8), 4)
    with pytest.raises(ValueError, match="values"):
        rl_cuda.expand(x, x[:5].clone(), torch.zeros(2, dtype=torch.int64),
                       0)
