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
# "chunked" cuts the walk at 1024 frames, so that each chunk's widths and
# payload land in their slices of one block (plain memory on the CPU, so its
# copies down are pageable) and nothing is joined; every route's walk marks
# each chunk's submit and drain
_WALK = {"flrl.walk.submit", "flrl.walk.drain"}
_FL_SPANS = {
    "dense": {"flrl.host.probe", "flrl.h2d.pinned", "flrl.kernels",
              "flrl.host.layout", "flrl.d2h.pinned", "flrl.host.out",
              "flrl.d2h.pageable"} | _WALK,
    "fields": {"flrl.host.probe", "flrl.h2d.pinned", "flrl.kernels",
               "flrl.host.layout", "flrl.d2h.pinned", "flrl.host.fold",
               "flrl.host.unfold", "flrl.host.out",
               "flrl.d2h.pageable"} | _WALK,
    "chunked": {"flrl.host.probe", "flrl.h2d.pinned", "flrl.kernels",
                "flrl.host.layout", "flrl.host.out",
                "flrl.d2h.pageable"} | _WALK,
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


# ---------------------------------------------------------------------------
# the walk's spans a chunk, on a file cut as the walk cuts a 3124 MiB file
# (three full 1 GiB chunks and a short tail): here chunks of 64 frames
# ---------------------------------------------------------------------------

_PIPELINE = ["submit", "submit", "drain", "submit", "drain", "submit",
             "drain", "drain"]


def _four_chunk_file(L, aligned, monkeypatch):
    """A stream of three full chunks and a tail of 20 frames (the tail's
    last frame short where not ``aligned``), the chunk cap patched to 64
    frames; each chunk's frames of mixed widths, so no closed form takes
    one."""
    monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", 64 * L)
    n = 3 * 64 * L + 20 * L - (0 if aligned else L // 2 + 3)
    g = np.random.default_rng(L + aligned)
    shift = g.integers(0, 8, -(-n // L), dtype=np.uint8).repeat(L)[:n]
    return g.integers(0, 256, n, dtype=np.uint8) >> shift


def _walk(got, thread=None):
    """The walk's ranges of ``got`` (of one thread where given), by
    start: their kinds, and the ranges themselves."""
    ranges = sorted((r for r in got if r.name.startswith("flrl.walk.")
                     and thread in (None, r.thread)), key=lambda r: r.start)
    return [r.name[len("flrl.walk."):] for r in ranges], ranges


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "ragged"])
@pytest.mark.parametrize("L", [128, 24])
def test_four_chunk_walk_spans_each_chunk(L, aligned, monkeypatch):
    """Under a CPU profiler, a four-chunk encode and decode through the
    library API each open one ``flrl.walk.submit`` and one
    ``flrl.walk.drain`` range a chunk, in the pipeline's order and one
    after another; the encode opens no ``flrl.host.join`` (each chunk
    lands in its slices of one block); the container is ``fl_numpy``'s and
    the round trip exact.  With the profiler off a walk span is the shared
    null context, and a walk enters no range."""
    import fl_rl_compression_mpi_tpu_torch as flrl
    import torch
    import torch_spans
    from fl_rl_compression_mpi_tpu_torch.utils import timers
    data = _four_chunk_file(L, aligned, monkeypatch)
    assert -(-data.size // fl_torch._device_cap(L)) == 4
    opts = dict(method="fl", frame_length=L, device="cpu")
    with torch_spans.spans() as enc:
        comp = flrl.compress(data, **opts)
    with torch_spans.spans() as dec:
        out = flrl.decompress(comp, **opts)
    bits, values = fl_numpy.encode(data, L)
    np.testing.assert_array_equal(comp.bits, bits)
    np.testing.assert_array_equal(comp.values, values)
    np.testing.assert_array_equal(out, data)
    for got in (enc, dec):
        torch_spans.check(got)
        kinds, ranges = _walk(got)
        assert kinds == _PIPELINE
        assert all(a.end <= b.start for a, b in zip(ranges, ranges[1:]))
    assert not [r for r in enc if r.name == "flrl.host.join"]
    _one_block(comp.bits, comp.values)

    def boom(*_, **__):
        raise AssertionError("a range entered with the profiler off")
    assert timers.stage(span="flrl.walk.submit") is timers._OFF
    assert timers.stage(span="flrl.walk.drain") is timers._OFF
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    again = flrl.compress(data, **opts)
    np.testing.assert_array_equal(again.values, values)
    np.testing.assert_array_equal(flrl.decompress(again, **opts), data)


@pytest.mark.parametrize("caller", ["stream", "fl-dist"])
def test_every_walk_caller_spans_each_chunk(caller, tmp_path, monkeypatch):
    """The stream's walks and each shard's walk of a mesh open one submit
    and one drain range a chunk, in the pipeline's order, on the thread
    that runs the walk."""
    import fl_rl_compression_mpi_tpu_torch as flrl
    import torch
    import torch_spans
    from fl_rl_compression_mpi_tpu_torch import stream
    from fl_rl_compression_mpi_tpu_torch.models import registry
    data = _four_chunk_file(128, False, monkeypatch)
    with torch_spans.spans() as got:
        if caller == "stream":
            src, comp = str(tmp_path / "in"), str(tmp_path / "c.fl")
            back = str(tmp_path / "back")
            data.tofile(src)
            # chunks of 64 frames of the input, in the encode and the decode
            monkeypatch.setattr(stream, "DEFAULT_CHUNK", 64 * 128)
            stream.compress_fl_stream(src, comp, device="cpu")
            stream.decompress_fl_stream(comp, back, device="cpu")
            out = np.fromfile(back, np.uint8)
        else:
            monkeypatch.setattr(registry, "default_device",
                                lambda: torch.device("cpu"))
            c = flrl.compress(data, method="fl-dist", devices=2)
            out = flrl.decompress(c, method="fl-dist", devices=2)
    np.testing.assert_array_equal(out, data)
    torch_spans.check(got)
    threads = {r.thread for r in got if r.name.startswith("flrl.walk.")}
    if caller == "stream":
        # one thread: the encode's four chunks, then the decode's
        assert _walk(got)[0] == _PIPELINE + _PIPELINE
    else:
        # each shard's walk in its card thread, both ways: two chunks each
        assert len(threads) >= 2
        assert sum(k == "submit" for k in _walk(got)[0]) == 8
        for t in threads:
            kinds = _walk(got, t)[0]
            assert len(kinds) % 4 == 0
            for i in range(0, len(kinds), 4):
                assert kinds[i:i + 4] == ["submit", "submit", "drain",
                                          "drain"]


# ---------------------------------------------------------------------------
# where the walk's results land: one block a call, which the caller holds
# ---------------------------------------------------------------------------

def _one_block(bits, values):
    """``bits`` and ``values`` are two views of one array, the widths right
    before the payload."""
    assert bits.base is not None and bits.base is values.base
    assert np.shares_memory(bits.base, values)
    assert bits.ctypes.data + bits.size == values.ctypes.data


def _four_chunks_of_every_kind(L, seed, monkeypatch):
    """A stream cut as :func:`_four_chunk_file` cuts it, whose chunks take
    each of the walk's paths: mixed widths (the kernels both ways), zeros
    (the encode's and the decode's closed forms), width 8 (the decode's
    identity) and a ragged tail of mixed widths."""
    monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", 64 * L)
    g = np.random.default_rng(seed)
    ck = 64 * L

    def mixed(n):
        shift = g.integers(0, 8, -(-n // L), dtype=np.uint8).repeat(L)[:n]
        return g.integers(0, 256, n, dtype=np.uint8) >> shift
    return np.concatenate([mixed(ck), np.zeros(ck, np.uint8),
                           g.integers(0, 256, ck, np.uint8) | 128,
                           mixed(20 * L - L // 2 - 3)])


@pytest.mark.parametrize("route", ["dense", "fields"])
@pytest.mark.parametrize("L", [128, 24, 8])
def test_multi_chunk_results_land_in_one_block(L, route, monkeypatch):
    """A four-chunk encode's widths and payload are two views of one
    array, equal to ``fl_numpy``'s; the decode returns one new array; a
    second encode and decode take blocks of their own and leave the first
    call's results as they were while the caller holds them; and
    ``decode_walk(out=)`` writes into the caller's array."""
    if route == "fields":
        monkeypatch.setenv("FLRL_NO_DENSE", "1")
    data = _four_chunks_of_every_kind(L, L, monkeypatch)
    assert -(-data.size // fl_torch._device_cap(L)) == 4
    want_b, want_v = fl_numpy.encode(data, L)
    bits, values = _enc(data, L)
    _one_block(bits, values)
    np.testing.assert_array_equal(bits, want_b)
    np.testing.assert_array_equal(values, want_v)
    out = _dec(data.size, bits, values, L)
    np.testing.assert_array_equal(out, data)

    other = data[::-1] ^ np.uint8(0x5A)
    other_b, other_v = _enc(other, L)
    _one_block(other_b, other_v)
    assert not np.shares_memory(other_v, values)
    np.testing.assert_array_equal(bits, want_b)
    np.testing.assert_array_equal(values, want_v)
    again = _dec(other.size, other_b, other_v, L)
    assert not np.shares_memory(again, out)
    np.testing.assert_array_equal(again, other)
    np.testing.assert_array_equal(out, data)

    widths = bits[:-(-data.size // L)]
    parts = fl_torch.walk_layout(data.size, widths, L)
    mine = np.full(data.size, 0xA5, np.uint8)
    got = fl_torch.decode_walk(data.size, widths, values, parts, L, "cpu",
                               out=mine)
    assert got is mine
    np.testing.assert_array_equal(mine, data)


def test_fl_walk_results_land_in_pinned_memory():
    """On a card, the decode's output (one part and four) and the
    four-chunk encode's container are pinned host memory, byte-exact, and
    the decode's copies down open ``flrl.d2h.pinned`` and no
    ``flrl.d2h.pageable``, the encode no ``flrl.host.join``.  Skips unless
    a CUDA device is present."""
    import torch
    import torch_spans
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned-memory cache")
    L = 128
    data = torch_spans.stream()
    bits, values = fl_torch.encode(data, L, device="cuda")
    out = fl_torch.decode(data.size, bits, values, L, device="cuda")
    assert torch.from_numpy(out).is_pinned()
    np.testing.assert_array_equal(out, data)
    with pytest.MonkeyPatch.context() as mp:
        data = _four_chunks_of_every_kind(L, 23, mp)
        with torch_spans.spans() as enc:
            bits, values = fl_torch.encode(data, L, device="cuda")
        with torch_spans.spans() as dec:
            out = fl_torch.decode(data.size, bits, values, L, device="cuda")
    for a in (bits, values, out):
        assert torch.from_numpy(a).is_pinned()
    _one_block(bits, values)
    want_b, want_v = fl_numpy.encode(data, L)
    np.testing.assert_array_equal(bits, want_b)
    np.testing.assert_array_equal(values, want_v)
    np.testing.assert_array_equal(out, data)
    assert "flrl.host.join" not in torch_spans.check(enc)
    got = torch_spans.check(dec)
    assert "flrl.d2h.pinned" in got and "flrl.d2h.pageable" not in got


# ---------------------------------------------------------------------------
# the decode's layout: part and shard bounds from block sums, checked whole
# ---------------------------------------------------------------------------

FRAMES = 212        # three parts of 64 frames and a tail of 20, at a cap of 64


def _scan(bits, n, L):
    """The payload's offset at each frame boundary, i64[F+1], from the
    definition: the exclusive scan of ceil(w·count/8), count being the
    frame's bytes."""
    F = -(-n // L)
    counts = np.minimum(n - np.arange(F, dtype=np.int64) * L, L)
    scan = np.zeros(F + 1, np.int64)
    np.cumsum((bits[:F].astype(np.int64) * counts + 7) // 8, out=scan[1:])
    return scan


def _stream_of_widths(widths, n, L, seed):
    """n bytes whose frames have exactly the widths ``widths``: random
    bytes below 2^w, each frame's first byte 2^w - 1."""
    g = np.random.default_rng(seed)
    top = (1 << widths.astype(np.int64)) - 1
    data = (g.integers(0, 256, widths.size * L) & top.repeat(L)).astype(
        np.uint8)
    data[::L] = top
    return data[:n]


def _widths(kind, seed):
    g = np.random.default_rng(seed)
    w = g.integers(1, 9, FRAMES).astype(np.uint8)
    if kind == "uniform":
        w[:] = 5
    elif kind == "mixed8":
        # the first and third part of 64 frames all at width 8
        w[:64] = w[128:192] = 8
    return w


def _held_to_scan(call, bits, values, scan, L, cap):
    """One walk's parts tile its n bytes from its first frame, each of at
    most the cap, and their frames, payload bounds and width range equal
    the scan's; the walk's payload is the scan's range of ``values``."""
    n, widths, vals, parts = call
    f = widths.ctypes.data - bits.ctypes.data     # the walk's first frame
    assert vals.ctypes.data - values.ctypes.data == scan[f]
    assert vals.size == scan[f + widths.size] - scan[f]
    off = 0
    for p in parts:
        assert p.n == min(cap, n - off)
        assert (p.f0, p.f1) == (off // L, off // L + -(-p.n // L))
        assert (p.v0, p.v1) == (scan[f + p.f0] - scan[f],
                                scan[f + p.f1] - scan[f])
        w = bits[f + p.f0:f + p.f1]
        assert (p.lo, p.hi) == (int(w.min()), int(w.max()))
        off += p.n
    assert off == n
    return len(parts)


@pytest.mark.parametrize("kind", ["random", "uniform", "mixed8"])
@pytest.mark.parametrize("nparts", [1, 4])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "ragged"])
@pytest.mark.parametrize("L", [8, 24, 128])
def test_walk_bounds_equal_the_scan(L, aligned, nparts, kind, monkeypatch):
    """The one-card decode's parts and each shard's walk on 3 and 4 CPU
    cards take their frames, payload bounds and width ranges from block
    sums; each equals an int64 exclusive scan of the frames' payload
    bytes, and the decoded bytes are ``fl_numpy``'s."""
    from fl_rl_compression_mpi_tpu_torch.container import FLCompressed
    from fl_rl_compression_mpi_tpu_torch.parallel import dist
    monkeypatch.delenv("FLRL_NO_DENSE", raising=False)
    if nparts == 4:
        monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", 64 * L)
    cap = fl_torch._device_cap(L)
    n = FRAMES * L - (0 if aligned else L // 2 + 3)
    data = _stream_of_widths(_widths(kind, L), n, L, L + nparts)
    bits, values = fl_numpy.encode(data, L)
    scan = _scan(bits, n, L)
    want = fl_numpy.decode(n, bits, values, L)
    np.testing.assert_array_equal(want, data)

    seen = []
    walk = fl_torch.decode_walk

    def spy(n, widths, values, parts, *args, **kwargs):
        seen.append((n, widths, values, parts))
        return walk(n, widths, values, parts, *args, **kwargs)
    monkeypatch.setattr(fl_torch, "decode_walk", spy)

    np.testing.assert_array_equal(_dec(n, bits, values, L), want)
    assert [_held_to_scan(c, bits, values, scan, L, cap)
            for c in seen] == [nparts]
    for cards in (3, 4):
        seen.clear()
        got = dist.decompress_fl(FLCompressed(bits, values, n), L,
                                 mesh=dist.make_mesh(cards, "cpu"))
        np.testing.assert_array_equal(got, want)
        assert len(seen) == cards
        starts = sorted(c[1].ctypes.data - bits.ctypes.data for c in seen)
        plan = dist.plan_shards(n, cards, L)
        assert starts == (plan.starts // L).tolist()
        for c in seen:
            _held_to_scan(c, bits, values, scan, L, cap)


@pytest.mark.parametrize("path", ["walk", "mesh"])
@pytest.mark.parametrize("fault", ["width0", "width9", "short"])
def test_fault_in_last_part_refused_before_any_launch(fault, path,
                                                      monkeypatch):
    """A container of four parts whose only fault lies in the last one (a
    width 0 or 9, or a payload one byte short) is refused with the
    container's message before any kernel runs: no kernel called, the
    launch counters as they were, and a caller's ``out=`` still holding
    its fill bytes; on 4 CPU cards the same, before any shard starts."""
    from fl_rl_compression_mpi_tpu_torch.container import FLCompressed
    from fl_rl_compression_mpi_tpu_torch.parallel import dist
    L = 128
    monkeypatch.delenv("FLRL_NO_DENSE", raising=False)
    monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", 64 * L)
    n = FRAMES * L - 9
    bits, values = fl_numpy.encode(
        _stream_of_widths(_widths("random", 1), n, L, 2), L)
    bits = bits.copy()
    if fault == "short":
        values = values[:-1]
        msg = (f"payload shorter than the widths imply: {values.size} < "
               f"{values.size + 1}")
    else:
        bits[200] = 0 if fault == "width0" else 9
        msg = f"width byte outside 1..8: {int(bits[200])}"
    assert -(-n // fl_torch._device_cap(L)) == 4 and 200 >= 3 * 64
    launches = dict(fl_dense_cuda.LAUNCHES)
    by_card = fl_dense_cuda.launches_by("device")
    calls = _spy(monkeypatch)
    with pytest.raises(ValueError, match=msg):
        if path == "mesh":
            dist.decompress_fl(FLCompressed(bits, values, n), L,
                               mesh=dist.make_mesh(4, "cpu"))
        else:
            _dec(n, bits, values, L)
    if path == "walk":
        widths = bits[:-(-n // L)]
        mine = np.full(n, 0xA5, np.uint8)
        with pytest.raises(ValueError, match=msg):
            fl_torch.decode_walk(n, widths, values,
                                 fl_torch.walk_layout(n, widths, L), L,
                                 "cpu", out=mine)
        assert (mine == 0xA5).all()
    assert calls == []
    assert fl_dense_cuda.LAUNCHES == launches
    assert fl_dense_cuda.launches_by("device") == by_card
