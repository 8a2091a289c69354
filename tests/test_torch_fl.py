"""The PyTorch package's FL codec (``fl_torch``, on the CPU) against the
JAX package's (``fl_jax``) and the reference binary's goldens.
Tolerance: byte equality throughout."""

import glob
import os

import numpy as np
import pytest

from fuzz_battery import battery
from fl_rl_compression_mpi_tpu import container
from fl_rl_compression_mpi_tpu.ops import fl_dense_pallas, fl_jax, fl_numpy
from fl_rl_compression_mpi_tpu_torch.ops import fl_dense_cuda, fl_torch

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference")
GOLDEN_BINS = sorted(glob.glob(os.path.join(GOLDEN, "case_*.bin")))
BATTERY = battery()


def _enc(data, L=128):
    return fl_torch.encode(data, L, device="cpu")


def _dec(n, bits, values, L=128):
    return fl_torch.decode(n, bits, values, L, device="cpu")


@pytest.mark.parametrize("i", range(len(BATTERY)))
def test_matches_fl_jax_on_battery(i):
    data = BATTERY[i]
    bits, values = _enc(data)
    jb, jv = fl_jax.encode(data)
    np.testing.assert_array_equal(bits, jb)
    np.testing.assert_array_equal(values, jv)
    np.testing.assert_array_equal(_dec(data.size, bits, values),
                                  fl_jax.decode(data.size, jb, jv))
    np.testing.assert_array_equal(_dec(data.size, bits, values), data)


@pytest.mark.parametrize("src", GOLDEN_BINS,
                         ids=[os.path.basename(p) for p in GOLDEN_BINS])
def test_reference_goldens_both_directions(src, tmp_path):
    data = np.fromfile(src, np.uint8)
    bits, values = _enc(data)
    out = str(tmp_path / "out.fl")
    container.save_fl(out, container.FLCompressed(bits, values, data.size))
    with open(out, "rb") as a, open(src[:-4] + ".fl", "rb") as b:
        assert a.read() == b.read()
    ref = container.load_fl(src[:-4] + ".fl")
    np.testing.assert_array_equal(
        _dec(ref.input_size, ref.bits, ref.values), data)


def test_reference_sample_bmp_container_decodes_like_fl_numpy():
    ref = container.load_fl(os.path.join(GOLDEN, "sample_bmp.fl"))
    np.testing.assert_array_equal(
        _dec(ref.input_size, ref.bits, ref.values),
        fl_numpy.decode(ref.input_size, ref.bits, ref.values))


@pytest.mark.parametrize("L", [64, 128])
def test_containers_cross_between_packages(L, tmp_path):
    """Files written by either package decode with the other."""
    g = np.random.default_rng(2)
    data = np.concatenate([g.integers(0, 8, 40_000, np.uint8),
                           g.integers(0, 256, 7_777, np.uint8)])
    a, b = str(tmp_path / "jax.fl"), str(tmp_path / "torch.fl")
    container.save_fl(a, container.FLCompressed(*fl_jax.encode(data, L),
                                                data.size))
    container.save_fl(b, container.FLCompressed(*_enc(data, L), data.size))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    ca, cb = container.load_fl(a), container.load_fl(b)
    np.testing.assert_array_equal(_dec(ca.input_size, ca.bits, ca.values, L),
                                  data)
    np.testing.assert_array_equal(
        fl_jax.decode(cb.input_size, cb.bits, cb.values, L), data)


@pytest.mark.parametrize("L", [8, 64, 128, 1024])
def test_chunk_walk_is_byte_identical(L, monkeypatch):
    g = np.random.default_rng(L)
    data = np.concatenate([g.integers(0, 1 << b, 2_000 + 37 * b)
                           for b in (3, 8, 1, 5, 2)]).astype(np.uint8)
    whole = _enc(data, L)
    monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", 3 * L + L // 2)
    assert fl_torch._device_cap(L) == 3 * L
    chunked = _enc(data, L)
    np.testing.assert_array_equal(chunked[0], whole[0])
    np.testing.assert_array_equal(chunked[1], whole[1])
    np.testing.assert_array_equal(_dec(data.size, *whole, L), data)


def _spy(monkeypatch):
    calls = []
    for name in ("frame_widths", "frame_offsets", "pack", "unpack"):
        orig = getattr(fl_dense_cuda, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls.append((_name, kw.get("fb", kw.get("fb_expect", 0))))
            return _orig(*a, **kw)
        monkeypatch.setattr(fl_dense_cuda, name, spy)
    return calls


def test_dispatch_uniform_stream_takes_uniform_mode(monkeypatch):
    g = np.random.default_rng(4)
    data = g.integers(0, 16, 600_000, np.uint8)
    data[::128] = 15
    calls = _spy(monkeypatch)
    bits, values = _enc(data)
    assert calls == [("frame_widths", 4), ("pack", 4)]
    calls.clear()
    np.testing.assert_array_equal(_dec(data.size, bits, values), data)
    assert calls == [("unpack", 4)]


def test_dispatch_flag_miss_takes_general_mode(monkeypatch):
    """A uniform first tile makes the host speculate: the uniform pack is
    launched with the widths, before the flag is read; the flag, read at
    the chunk's drain, catches the wider frame later on and the general
    pack runs."""
    g = np.random.default_rng(5)
    data = g.integers(0, 16, 600_000, np.uint8)
    data[::128] = 15
    data[590_000] = 255
    calls = _spy(monkeypatch)
    bits, values = _enc(data)
    assert calls == [("frame_widths", 4), ("pack", 4), ("frame_offsets", 0),
                     ("pack", 0)]
    bg, vg = fl_numpy.encode(data)
    np.testing.assert_array_equal(values, vg)
    calls.clear()
    np.testing.assert_array_equal(_dec(data.size, bits, values), data)
    assert calls == [("frame_offsets", 0), ("unpack", 0)]


def test_dispatch_host_closed_forms_skip_the_device(monkeypatch):
    calls = _spy(monkeypatch)
    const = np.full(10_001, 5, np.uint8)
    bits, values = _enc(const)
    np.testing.assert_array_equal(_dec(const.size, bits, values), const)
    w8 = np.random.default_rng(6).integers(128, 256, 5_000).astype(np.uint8)
    bits, values = fl_numpy.encode(w8)
    np.testing.assert_array_equal(_dec(w8.size, bits, values), w8)
    assert calls == []


def test_host_helpers_match_fl_jax():
    g = np.random.default_rng(8)
    for c in (0, 1, 5, 77, 255):
        for n in (1, 127, 128, 1000, 4097):
            for L in (8, 128):
                ours = fl_torch._constant_container(c, n, L)
                ref = fl_jax._constant_container(c, n, L)
                np.testing.assert_array_equal(ours[0], ref[0])
                np.testing.assert_array_equal(ours[1], ref[1])
                assert (fl_torch.host_constant_decode_probe(*ours, n, L)
                        == fl_jax.host_constant_decode_probe(*ref, n, L)
                        == c)
    for data in (g.integers(0, 256, 3000).astype(np.uint8),
                 g.integers(128, 256, 3000).astype(np.uint8),
                 g.integers(0, 16, 3000).astype(np.uint8)):
        bits, values = fl_numpy.encode(data)
        for probe in ("host_constant_decode_probe",
                      "host_identity_decode_probe"):
            ours = getattr(fl_torch, probe)(bits, values, data.size)
            ref = getattr(fl_jax, probe)(bits, values, data.size)
            assert (ours is None) == (ref is None)
            if ours is not None:
                np.testing.assert_array_equal(ours, ref)
    assert fl_torch._device_cap(24) == fl_jax._device_cap(24)
    assert fl_dense_cuda.DENSE_UNIFORM_TILE_R == \
        fl_dense_pallas.DENSE_UNIFORM_TILE_R


@pytest.fixture
def container16():
    data = np.random.default_rng(0).integers(0, 16, 10_000, np.uint8)
    bits, values = fl_numpy.encode(data)
    return data, bits, values


@pytest.mark.parametrize("bad_width", [0, 9, 200])
def test_rejects_bad_width_byte_before_any_launch(bad_width, container16,
                                                  monkeypatch):
    data, bits, values = container16
    bits = bits.copy()
    bits[3] = bad_width
    calls = _spy(monkeypatch)
    with pytest.raises(ValueError, match="width byte"):
        _dec(data.size, bits, values)
    assert calls == []


def test_rejects_short_payload_before_any_launch(container16, monkeypatch):
    data, bits, values = container16
    calls = _spy(monkeypatch)
    with pytest.raises(ValueError, match="payload shorter"):
        _dec(data.size, bits, values[:-5])
    assert calls == []


def test_rejects_short_widths(container16):
    data, bits, values = container16
    with pytest.raises(ValueError, match="bits array shorter"):
        _dec(data.size, bits[:10], values)
    with pytest.raises(ValueError, match="bits array shorter"):
        _dec(data.size, bits[:0], values)


@pytest.mark.parametrize("L", [0, 12, -8])
def test_rejects_bad_frame_length(L):
    with pytest.raises(ValueError):
        _enc(np.arange(100, dtype=np.uint8), L)
    with pytest.raises(ValueError):
        _dec(100, np.ones(2, np.uint8), np.zeros(100, np.uint8), L)


def test_empty_input():
    bits, values = _enc(np.zeros(0, np.uint8))
    assert bits.size == 0 and values.size == 0
    assert _dec(0, bits, values).size == 0


def test_cpu_run_launches_no_kernel():
    before = dict(fl_dense_cuda.LAUNCHES)
    data = np.random.default_rng(1).integers(0, 64, 50_000, np.uint8)
    np.testing.assert_array_equal(_dec(data.size, *_enc(data)), data)
    assert fl_dense_cuda.LAUNCHES == before


# the spans an FL round trip on the CPU leaves under a profiler, by route;
# "chunked" cuts the walk at 1024 frames, so that the encode joins chunks
_FL_SPANS = {
    "dense": {"flrl.host.probe", "flrl.h2d.pinned", "flrl.kernels",
              "flrl.host.layout", "flrl.d2h.pinned", "flrl.host.out",
              "flrl.d2h.pageable"},
    "fields": {"flrl.host.probe", "flrl.h2d.pinned", "flrl.kernels",
               "flrl.host.layout", "flrl.d2h.pinned", "flrl.host.fold",
               "flrl.host.unfold", "flrl.host.out", "flrl.d2h.pageable"},
    "chunked": {"flrl.host.probe", "flrl.h2d.pinned", "flrl.kernels",
                "flrl.host.layout", "flrl.d2h.pinned", "flrl.host.out",
                "flrl.host.join", "flrl.d2h.pageable"},
}


@pytest.mark.parametrize("route", sorted(_FL_SPANS))
def test_round_trip_spans_under_a_profiler(route, monkeypatch):
    """Under a CPU profiler, an ``fl`` compress and decompress through the
    library API leave each stage's span (``utils/timers.py``'s families),
    nested inside the caller's range, and the same containers."""
    import fl_rl_compression_mpi_tpu_torch as flrl
    import torch_spans
    if route == "fields":
        monkeypatch.setenv("FLRL_NO_DENSE", "1")
    if route == "chunked":
        monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", 1024 * 128)
    data = torch_spans.stream()
    with torch_spans.spans() as got:
        comp = flrl.compress(data, method="fl", device="cpu")
        out = flrl.decompress(comp, method="fl", device="cpu")
    np.testing.assert_array_equal(out, data)
    np.testing.assert_array_equal(comp.values, fl_numpy.encode(data)[1])
    assert torch_spans.check(got) == _FL_SPANS[route]
