"""Streaming FL (``stream.py``) and the pipelined chunk walk
(``fl_torch.encode_chunks`` / ``decode_chunks``) of the PyTorch package, on
the CPU: every case of ``tests/test_stream.py``, each stream container held
byte for byte against the JAX package's ``stream.compress_fl_stream`` on
the same file and against fl-cpu's; the walk at depth 1, 2 and 3 on both
FL routes; the decode's rejections, each before an output byte is written;
``--coordinator`` with ``--stream-chunk-mb``.  Tolerance: byte equality
throughout."""

import collections
import glob
import os
import socket

import numpy as np
import pytest
import torch

import fl_rl_compression_mpi_tpu_torch as flrl
from fl_rl_compression_mpi_tpu import stream as jax_stream
from fl_rl_compression_mpi_tpu_torch import container, stream
from fl_rl_compression_mpi_tpu_torch.cli import main
from fl_rl_compression_mpi_tpu_torch.models import registry
from fl_rl_compression_mpi_tpu_torch.ops import fl_dense_cuda, fl_fields_cuda
from fl_rl_compression_mpi_tpu_torch.ops import fl_numpy, fl_torch
from fl_rl_compression_mpi_tpu_torch.utils.timers import set_stage_timers

CPU = torch.device("cpu")
ROUTES = ("dense", "fields")


@pytest.fixture(autouse=True)
def _stage_timers_off():
    yield
    set_stage_timers(False)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(registry, "default_device", lambda: CPU)


def _route(monkeypatch, route: str) -> None:
    if route == "fields":
        monkeypatch.setenv("FLRL_NO_DENSE", "1")
    else:
        monkeypatch.delenv("FLRL_NO_DENSE", raising=False)


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _fl_cpu_container(data: np.ndarray, path: str, L: int = 128) -> str:
    comp = registry.CODECS["fl-cpu"].compress(data, frame_length=L)
    container.save_fl(path, comp)
    return path


def _leftovers(tmp_path) -> list:
    return (glob.glob(str(tmp_path / "*.flrl.tmp"))
            + glob.glob(str(tmp_path / "*.flrl.verify")))


# ---------------------------------------------------------------------------
# The cases of tests/test_stream.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [128 * 100, 128 * 257 + 55, 1000])
def test_stream_matches_whole_file(tmp_path, size):
    data = np.random.default_rng(size).integers(0, 64, size, np.uint8)
    src = str(tmp_path / "in.bin")
    data.tofile(src)
    whole = _fl_cpu_container(data, str(tmp_path / "whole.fl"))
    out = str(tmp_path / "stream.fl")
    stream.compress_fl_stream(src, out, chunk_mb=1, device=CPU)
    theirs = str(tmp_path / "jax.fl")
    jax_stream.compress_fl_stream(src, theirs, chunk_mb=1)
    assert _bytes(out) == _bytes(whole) == _bytes(theirs)
    back = str(tmp_path / "back.bin")
    stream.decompress_fl_stream(out, back, chunk_mb=1, device=CPU)
    np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)
    assert not _leftovers(tmp_path)


def test_stream_tiny_chunks(tmp_path):
    """A chunk below one frame floors to one frame and still matches."""
    data = np.random.default_rng(1).integers(0, 256, 128 * 33 + 5, np.uint8)
    src = str(tmp_path / "in.bin")
    data.tofile(src)
    out = str(tmp_path / "s.fl")
    stream.compress_fl_stream(src, out, chunk_mb=0, device=CPU)
    comp = container.load_fl(out)
    bits_g, values_g = fl_numpy.encode(data)
    np.testing.assert_array_equal(comp.bits, bits_g)
    np.testing.assert_array_equal(comp.values, values_g)
    theirs = str(tmp_path / "jax.fl")
    jax_stream.compress_fl_stream(src, theirs, chunk_mb=0)
    assert _bytes(out) == _bytes(theirs)
    back = str(tmp_path / "b.bin")
    stream.decompress_fl_stream(out, back, chunk_mb=0, device=CPU)
    np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)


def test_stream_empty(tmp_path):
    src = str(tmp_path / "e.bin")
    open(src, "wb").close()
    out = str(tmp_path / "e.fl")
    stream.compress_fl_stream(src, out, device=CPU)
    assert _bytes(out) == b"\x00" * 24
    back = str(tmp_path / "e2.bin")
    stream.decompress_fl_stream(out, back, device=CPU)
    assert _bytes(back) == b""
    assert not _leftovers(tmp_path)


def test_stream_cli(tmp_path, on_cpu):
    data = np.random.default_rng(2).integers(0, 32, 300_000, np.uint8)
    src = str(tmp_path / "in.bin")
    data.tofile(src)
    comp = str(tmp_path / "o.fl")
    back = str(tmp_path / "o.bin")
    assert main(["c", "fl", src, comp, "--stream-chunk-mb", "1"]) == 0
    assert main(["d", "fl", comp, back, "--stream-chunk-mb", "1"]) == 0
    np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)
    assert _bytes(comp) == _bytes(_fl_cpu_container(
        data, str(tmp_path / "cpu.fl")))
    # containers interoperate with the methods that do not stream
    back2 = str(tmp_path / "o2.bin")
    assert main(["d", "fl-cpu", comp, back2]) == 0
    np.testing.assert_array_equal(np.fromfile(back2, np.uint8), data)


def test_stream_rejects_rl(tmp_path, capsys):
    src = str(tmp_path / "x.bin")
    np.zeros(10, np.uint8).tofile(src)
    assert main(["c", "rl", src, str(tmp_path / "x.rl"),
                 "--stream-chunk-mb", "1"]) == 2
    assert ("[ERROR] --stream-chunk-mb supports FL methods only"
            in capsys.readouterr().err)
    assert not os.path.exists(tmp_path / "x.rl")


def test_stream_cli_verify(tmp_path, capsys, on_cpu):
    data = np.random.default_rng(3).integers(0, 32, 300_000, np.uint8)
    src = str(tmp_path / "in.bin")
    data.tofile(src)
    comp = str(tmp_path / "o.fl")
    assert main(["c", "fl", src, comp, "--stream-chunk-mb", "1",
                 "--verify", "--timers"]) == 0
    captured = capsys.readouterr()
    assert "verification OK" in captured.err
    assert "[TIMER] streaming compression:" in captured.out
    # a corrupted container fails the verify
    blob = bytearray(_bytes(comp))
    blob[-1] ^= 0xFF
    with open(comp, "wb") as f:
        f.write(bytes(blob))
    assert not stream.verify_fl_stream(src, comp, 128, 1, device=CPU)
    assert not _leftovers(tmp_path)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("route", ROUTES)
def test_pipelined_chunk_codec_dense_paths(monkeypatch, route, depth):
    """The pipelined walk over the chunk classes: constant (host closed
    form), uniform (speculative pack, flag read at drain), uniform-miss
    (head uniform, tail frame not: the general pack re-run at drain),
    mixed, width 8 (the decode's identity) and a ragged tail; on the
    field route, pack-2 hits and misses re-run on the kept words.  The
    bytes are fl_numpy's at every depth, also when the decode's parts
    come from one reused buffer, as the stream's do."""
    _route(monkeypatch, route)
    # a probe tile of 4 KiB, so that an 8 KiB chunk takes the speculation
    monkeypatch.setattr(fl_dense_cuda, "DENSE_UNIFORM_TILE_R", 8)
    calls = collections.Counter()
    modes = {"frame_widths": lambda a, kw: kw.get("fb_expect", 0),
             "frame_offsets": lambda a, kw: 0,
             "pack": lambda a, kw: kw.get("fb", 0),
             "encode_fields": lambda a, kw: a[2]}
    for name, mode in modes.items():
        mod = fl_fields_cuda if name == "encode_fields" else fl_dense_cuda

        def spy(*a, _orig=getattr(mod, name), _name=name, _mode=mode, **kw):
            calls[_name, _mode(a, kw)] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    rng = np.random.default_rng(5)
    ck = 128 * 64
    const = np.full(ck, 9, np.uint8)
    uni = rng.integers(0, 16, ck, np.uint8) | 8          # uniform width 4
    miss = uni.copy()
    miss[-128:] = 1                     # the last frame at width 1
    # a random width a frame
    mixed = (rng.integers(0, 256, ck, np.uint16)
             >> rng.integers(0, 8, 64).repeat(128)).astype(np.uint8)
    w8 = rng.integers(0, 256, ck, np.uint8) | 128      # the decode's identity
    tail = rng.integers(0, 64, 777, np.uint8)
    chunks = [const, uni, miss, mixed, w8, const, w8, tail]
    data = np.concatenate(chunks)
    parts = [(b, v.copy()) for b, v in fl_torch.encode_chunks(
        iter(chunks), device=CPU, depth=depth)]
    bg, vg = fl_numpy.encode(data)
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), bg)
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), vg)
    if route == "dense":
        assert calls == {("frame_widths", 4): 2, ("frame_widths", 8): 2,
                         ("frame_widths", 0): 2, ("pack", 4): 2,
                         ("pack", 8): 2, ("frame_offsets", 0): 3,
                         ("pack", 0): 3}
    else:                   # mixed, w8 and the tail miss pack-2
        assert calls == {("encode_fields", fl_torch.PACK_TILE_R): 6,
                         ("encode_fields", 0): 4}
    # the decode: each chunk's widths and payload
    dparts = [(c.size, b, v) for c, (b, v) in zip(chunks, parts)]
    outs = [o.copy() for o in fl_torch.decode_chunks(
        iter(dparts), device=CPU, depth=depth)]
    np.testing.assert_array_equal(np.concatenate(outs), data)
    reused = np.empty(ck, np.uint8)

    def from_one_buffer():
        for n, b, v in dparts:
            reused[:v.size] = v
            yield n, b, reused[:v.size]

    outs = [o.copy() for o in fl_torch.decode_chunks(
        from_one_buffer(), device=CPU, depth=depth)]
    np.testing.assert_array_equal(np.concatenate(outs), data)
    out = np.empty(data.size, np.uint8)
    for _ in fl_torch.decode_chunks(iter(dparts), device=CPU, depth=depth,
                                    out=out):
        pass
    np.testing.assert_array_equal(out, data)


def test_encode_chunks_rejects_misaligned_middle_chunk():
    """Frame alignment is the byte-identity invariant: a misaligned chunk
    that is not the last raises instead of changing the container."""
    chunks = [np.zeros(100, np.uint8), np.zeros(128, np.uint8)]
    with pytest.raises(ValueError, match="last"):
        list(fl_torch.encode_chunks(iter(chunks), device=CPU))
    ok = list(fl_torch.encode_chunks(iter(
        [np.zeros(256, np.uint8), np.zeros(100, np.uint8)]), device=CPU))
    assert len(ok) == 2


@pytest.mark.parametrize("route", ROUTES)
def test_chunked_codec_random_split_equivalence(monkeypatch, route):
    """For random frame-aligned splits of streams that mix constant spans,
    width-8 spans and mixed widths, the walk gives fl_numpy's bytes and
    its decode inverts them."""
    _route(monkeypatch, route)
    rng = np.random.default_rng(13)
    for trial in range(6):
        spans = []
        for _ in range(rng.integers(2, 6)):
            kind = rng.integers(0, 3)
            ln = int(rng.integers(1, 40)) * 128
            if kind == 0:
                spans.append(np.full(ln, int(rng.integers(0, 256)),
                                     np.uint8))
            elif kind == 1:
                s = rng.integers(0, 256, ln).astype(np.uint8)
                s[::128] |= 128
                spans.append(s)
            else:
                spans.append(rng.integers(
                    0, 1 << int(rng.integers(1, 9)), ln).astype(np.uint8))
        data = np.concatenate(spans)[: -int(rng.integers(0, 120)) or None]
        bg, vg = fl_numpy.encode(data)
        nfr = -(-data.size // 128)
        cuts = np.sort(rng.choice(np.arange(1, nfr), size=min(
            int(rng.integers(1, 5)), nfr - 1), replace=False)) * 128
        chunks = np.split(data, cuts)
        parts = [(b, v.copy()) for b, v in fl_torch.encode_chunks(
            iter(chunks), device=CPU)]
        np.testing.assert_array_equal(
            np.concatenate([p[0] for p in parts]), bg, err_msg=str(trial))
        np.testing.assert_array_equal(
            np.concatenate([p[1] for p in parts]), vg, err_msg=str(trial))
        dparts = [(c.size, b, v) for c, (b, v) in zip(chunks, parts)]
        outs = [o.copy() for o in fl_torch.decode_chunks(iter(dparts),
                                                         device=CPU)]
        np.testing.assert_array_equal(np.concatenate(outs), data,
                                      err_msg=str(trial))


def test_chunked_codec_device_cap_split(monkeypatch):
    """A chunk above the device cap is split frame-aligned, with a pair
    for each piece."""
    monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", 128 * 64)
    rng = np.random.default_rng(21)
    data = rng.integers(0, 64, 128 * 300 + 17, np.uint8)
    parts = [(b, v.copy()) for b, v in fl_torch.encode_chunks(
        iter([data]), device=CPU)]
    assert len(parts) > 1
    bg, vg = fl_numpy.encode(data)
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), bg)
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), vg)
    outs = [o.copy() for o in fl_torch.decode_chunks(
        iter([(data.size, bg, vg)]), device=CPU)]
    assert len(outs) > 1
    np.testing.assert_array_equal(np.concatenate(outs), data)


def test_decode_rejects_empty_widths_nonzero_claim():
    """n > 0 with an empty widths array is a corrupt container: it raises
    instead of returning a truncated output."""
    with pytest.raises(ValueError, match="corrupt"):
        fl_torch.decode(1000, np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                        device=CPU)
    with pytest.raises(ValueError, match="corrupt"):
        list(fl_torch.decode_chunks(iter(
            [(1000, np.zeros(0, np.uint8), np.zeros(0, np.uint8))]),
            device=CPU))


def test_api_accepts_python_bytes():
    raw = bytes(range(200)) * 80
    want = np.frombuffer(raw, np.uint8)
    comp = flrl.compress(raw, method="fl-cpu")
    np.testing.assert_array_equal(flrl.decompress(comp, method="fl-cpu"),
                                  want)
    comp = flrl.compress(raw, method="fl", device=CPU)
    np.testing.assert_array_equal(
        flrl.decompress(comp, method="fl", device=CPU), want)


# ---------------------------------------------------------------------------
# The port's own cases
# ---------------------------------------------------------------------------

def _corrupt(kind: str, good: str, bad: str) -> None:
    blob = bytearray(_bytes(good))
    n, nb, nv = container._HEADER.unpack(bytes(blob[:24]))
    if kind == "short-widths":
        blob[:24] = container._HEADER.pack(n + 128 * 4, nb, nv)
    elif kind == "width-byte":
        blob[24 + nb // 2] = 9
    else:                               # the file ends inside the payload
        del blob[-5:]
    with open(bad, "wb") as f:
        f.write(bytes(blob))


@pytest.mark.parametrize("kind", ["short-widths", "width-byte",
                                  "short-payload"])
def test_stream_decode_rejects_before_writing(tmp_path, kind):
    """A corrupt container raises before the decode writes an output byte
    (the output is not even made), and neither the decode nor the verify
    leaves a temporary file behind."""
    data = np.random.default_rng(31).integers(0, 64, 128 * 200 + 9, np.uint8)
    src = str(tmp_path / "in.bin")
    data.tofile(src)
    good = str(tmp_path / "good.fl")
    stream.compress_fl_stream(src, good, chunk_mb=0, device=CPU)
    bad = str(tmp_path / "bad.fl")
    _corrupt(kind, good, bad)
    out = str(tmp_path / "out.bin")
    with pytest.raises((OSError, ValueError), match="corrupt"):
        stream.decompress_fl_stream(bad, out, chunk_mb=0, device=CPU)
    assert not os.path.exists(out)
    with pytest.raises((OSError, ValueError), match="corrupt"):
        stream.verify_fl_stream(src, bad, 128, 0, device=CPU)
    assert not _leftovers(tmp_path)
    assert sorted(os.listdir(tmp_path)) == ["bad.fl", "good.fl", "in.bin"]


def test_stream_compress_leaves_no_temporary_file_on_error(tmp_path,
                                                          monkeypatch):
    """A walk that fails mid-stream removes the spooled payload."""
    data = np.random.default_rng(32).integers(0, 64, 3 << 20, np.uint8)
    src = str(tmp_path / "in.bin")
    data.tofile(src)

    def broken(*a, **kw):
        yield np.zeros(0, np.uint8), np.zeros(0, np.uint8)
        raise RuntimeError("a kernel failed")

    monkeypatch.setattr(fl_torch, "encode_chunks", broken)
    with pytest.raises(RuntimeError, match="kernel failed"):
        stream.compress_fl_stream(src, str(tmp_path / "o.fl"), chunk_mb=1,
                                  device=CPU)
    assert not _leftovers(tmp_path)
    assert not os.path.exists(tmp_path / "o.fl")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("L", [64, 128, 1024])
def test_stream_both_routes_and_frame_lengths(tmp_path, monkeypatch, route,
                                              L):
    """Chunks that split a frame-aligned file, with a ragged tail, on both
    routes: the JAX stream's container and fl-cpu's, and the round trip."""
    _route(monkeypatch, route)
    rng = np.random.default_rng(L)
    data = np.concatenate([rng.integers(0, 16, (1 << 20) + 3 * L, np.uint8),
                           np.zeros(L * 5, np.uint8),
                           rng.integers(0, 256, (1 << 20) + 41, np.uint8)])
    src = str(tmp_path / "in.bin")
    data.tofile(src)
    out = str(tmp_path / "s.fl")
    stream.compress_fl_stream(src, out, L, 1, device=CPU)
    theirs = str(tmp_path / "jax.fl")
    jax_stream.compress_fl_stream(src, theirs, L, 1)
    whole = _fl_cpu_container(data, str(tmp_path / "cpu.fl"), L)
    assert _bytes(out) == _bytes(theirs) == _bytes(whole)
    assert stream.verify_fl_stream(src, out, L, 1, device=CPU)
    assert not _leftovers(tmp_path)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("method", ["fl", "rl"])
def test_coordinator_takes_precedence_over_streaming(tmp_path, on_cpu,
                                                     monkeypatch, method):
    """With ``--coordinator`` the CLI takes the multi-process path
    first, as the JAX CLI does: no stream function runs, and RL is not
    refused."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)

    def refuse(*a, **kw):
        raise AssertionError("the stream ran")

    monkeypatch.setattr(stream, "compress_fl_stream", refuse)
    data = np.random.default_rng(33).integers(0, 32, 128 * 500 + 3, np.uint8)
    src = str(tmp_path / "in.bin")
    data.tofile(src)
    out = str(tmp_path / "o.c")
    try:
        assert main(["c", method, src, out, "--stream-chunk-mb", "1",
                     "--coordinator", f"127.0.0.1:{_free_port()}",
                     "--num-processes", "1", "--process-id", "0"]) == 0
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    codec = registry.CODECS[f"{method}-cpu"]
    back = codec.decompress(flrl.api.load_container(method, out))
    np.testing.assert_array_equal(back, data)
    if method == "fl":
        assert _bytes(out) == _bytes(_fl_cpu_container(
            data, str(tmp_path / "cpu.fl")))
