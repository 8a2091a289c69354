"""The PyTorch package's FL field route on the CPU against the JAX package:
the plain versions of the field kernels against ``fl_jax.fl_encode_fields``
and ``fl_decode_fields`` (XLA), the host glue against the JAX package's
``ops/fields.py`` (native and NumPy), and ``fl_torch`` with
``FLRL_NO_DENSE=1`` against ``fl_jax.encode/decode``, which take the XLA
field route on the CPU.  ``test_torch_fields_pallas.py`` holds the plain
versions against the Pallas kernels.  Tolerance: byte equality throughout."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fuzz_battery import battery
from fl_rl_compression_mpi_tpu import container
from fl_rl_compression_mpi_tpu.ops import fields as jax_fields
from fl_rl_compression_mpi_tpu.ops import fl_jax, fl_numpy
from fl_rl_compression_mpi_tpu_torch.ops import fields
from fl_rl_compression_mpi_tpu_torch.ops import fl_dense_cuda
from fl_rl_compression_mpi_tpu_torch.ops import fl_fields_cuda as fk
from fl_rl_compression_mpi_tpu_torch.ops import fl_torch

FRAME_LENGTHS = (8, 24, 64, 128, 512, 1024)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference")
GOLDEN_BINS = sorted(glob.glob(os.path.join(GOLDEN, "case_*.bin")))


def _width_cases():
    g = np.random.default_rng(17)
    out = []
    for b in range(1, 9):
        d = g.integers(0, 1 << b, 3000 + 13 * b).astype(np.uint8)
        d[::61] = (1 << b) - 1          # pins the width of most frames
        out.append((f"w{b}", d))
    return out


CASES = ([(f"battery{i}", d) for i, d in enumerate(battery())]
         + _width_cases())


def _frames_of_widths(g, widths, L):
    masks = ((1 << widths.astype(np.int64)) - 1).astype(np.uint8)
    data = g.integers(0, 256, (widths.size, L), np.uint8) & masks[:, None]
    data[:, 0] = masks
    return data.reshape(-1)


def _stream(seed, n, L, top):
    """n bytes of frames of random widths 1..top."""
    g = np.random.default_rng(seed)
    return _frames_of_widths(g, g.integers(1, top + 1, -(-n // L)), L)[:n]


def _words(data, L):
    """Zero-padded u32 words of ``data``: at least 1024 frames, a power of
    two, so the XLA functions compile for few shapes."""
    frames = max(1024, -(-data.size // L))
    frames = 1 << (frames - 1).bit_length()
    buf = np.zeros(frames * L, np.uint8)
    buf[:data.size] = data
    return buf.view(np.uint32)


def _t(a):
    return torch.from_numpy(np.array(a).view(np.int32))


# ---------------------------------------------------------------------------
# (a) the plain versions against the XLA field functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", FRAME_LENGTHS)
@pytest.mark.parametrize("name,data", CASES, ids=[c[0] for c in CASES])
def test_twins_match_xla_field_functions(name, data, L):
    n = data.size
    w = _words(data, L)
    jb, jf = fl_jax.fl_encode_fields(jnp.asarray(w), jnp.int32(n),
                                     frame_length=L)
    bits, f = fk.encode_fields(_t(w), L)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(f.numpy().view(np.uint32), np.asarray(jf))
    jout = fl_jax.fl_decode_fields(jf, jb, jnp.int32(n), frame_length=L)
    out = fk.decode_fields(f, bits, L).numpy().view(np.uint8)
    np.testing.assert_array_equal(out[:n], np.asarray(jout).view(np.uint8)[:n])
    np.testing.assert_array_equal(out[:n], data)


# ---------------------------------------------------------------------------
# (b) fields and widths cross between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", FRAME_LENGTHS)
def test_fields_cross_between_packages(L):
    data = _stream(L, 40 * L + 77 % L, L, 8)
    n = data.size
    w = _words(data, L)
    jb, jf = fl_jax.fl_encode_fields(jnp.asarray(w), jnp.int32(n),
                                     frame_length=L)
    # JAX's fields and flat widths into the port's decode
    out = fk.decode_fields(_t(np.asarray(jf)),
                           torch.from_numpy(np.array(jb)), L)
    np.testing.assert_array_equal(out.numpy().view(np.uint8)[:n], data)
    # the port's fields into JAX's decode
    bits, f = fk.encode_fields(_t(w), L)
    jout = fl_jax.fl_decode_fields(jnp.asarray(f.numpy().view(np.uint32)),
                                   jnp.asarray(bits.numpy()), jnp.int32(n),
                                   frame_length=L)
    np.testing.assert_array_equal(np.asarray(jout).view(np.uint8)[:n], data)


def test_pack2_layout_matches_host_pack():
    """The pack-2 plain versions keep each field's low 16 bits at the slot
    the host's ``pack_p2`` / ``unpack_p2`` give it."""
    L, tr = 128, 16
    data = _stream(3, 5 * tr * 512 + 99, L, 4)
    w = np.zeros(6 * tr * 512, np.uint8)
    w[:data.size] = data
    bits, f = fk.encode_fields(_t(w.view(np.uint32)), L)
    bits2, p = fk.encode_fields(_t(w.view(np.uint32)), L, tr)
    np.testing.assert_array_equal(bits2.numpy(), bits.numpy())
    np.testing.assert_array_equal(
        p.numpy().view(np.uint32),
        fields.pack_p2(f.numpy().view(np.uint32), tr))
    np.testing.assert_array_equal(
        fields.unpack_p2(p.numpy().view(np.uint32), f.numel(), tr),
        f.numpy().view(np.uint32))
    np.testing.assert_array_equal(fk.decode_fields(p, bits, L, tr).numpy(),
                                  fk.decode_fields(f, bits, L).numpy())
    assert fk.packed_words(f.numel(), tr) == p.numel()


# ---------------------------------------------------------------------------
# (c) host glue against the JAX package's ops/fields.py
# ---------------------------------------------------------------------------

@pytest.fixture(params=["native", "numpy"])
def host(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(fields, "get_native", lambda: None)
        monkeypatch.setattr(jax_fields, "get_native", lambda: None)
        assert fields.host_fold_kind() == "numpy"
    return request.param


@pytest.mark.parametrize("L", FRAME_LENGTHS)
def test_host_glue_matches_jax_fields(L, host):
    for top, seed in ((8, 1), (4, 2)):
        data = _stream(seed + L, 37 * L + 5, L, top)
        n = data.size
        bits, values = fl_numpy.encode(data, L)
        spread = fields.spread_fields(data, bits, L)
        np.testing.assert_array_equal(
            spread, jax_fields.spread_fields(data, bits, L))
        np.testing.assert_array_equal(
            fields.unspread_fields(spread, bits, n, L),
            jax_fields.unspread_fields(spread, bits, n, L))
        flds = fields.unfold(values, bits, n, L)
        np.testing.assert_array_equal(
            flds, jax_fields.unfold(values, bits, n, L))
        np.testing.assert_array_equal(flds, spread)
        folded = fields.fold(flds, bits, n, L)
        np.testing.assert_array_equal(
            folded, jax_fields.fold(flds, bits, n, L))
        np.testing.assert_array_equal(folded, values)
        if top > 4 or 128 % (L // 4):
            continue
        for tr in (16, 32):
            pw = fk.packed_words(bits.size * (L // 4), tr)
            packed = fields.unfold_p2(values, bits, n, L, tr, pw)
            np.testing.assert_array_equal(
                packed, jax_fields.unfold_p2(values, bits, n, L, tr, pw))
            buf = np.zeros(2 * pw, np.uint32)
            buf[:flds.size] = flds
            np.testing.assert_array_equal(fields.pack_p2(buf, tr), packed)
            np.testing.assert_array_equal(
                fields.unpack_p2(packed, flds.size, tr), flds)
            np.testing.assert_array_equal(
                fields.fold_p2(packed, bits, n, L, tr),
                jax_fields.fold_p2(packed, bits, n, L, tr))
            np.testing.assert_array_equal(
                fields.fold_p2(packed, bits, n, L, tr), values)


# ---------------------------------------------------------------------------
# (d) the dispatch with FLRL_NO_DENSE=1 against fl_jax.encode/decode
# ---------------------------------------------------------------------------

def _enc(data, L=128):
    return fl_torch.encode(data, L, device="cpu")


def _dec(n, bits, values, L=128):
    return fl_torch.decode(n, bits, values, L, device="cpu")


@pytest.fixture
def field_route(monkeypatch):
    monkeypatch.setenv("FLRL_NO_DENSE", "1")


def _spy(monkeypatch):
    """Record every kernel wrapper call: (name, tile_r or fb)."""
    calls = []
    for mod, names in ((fl_dense_cuda, ("frame_widths", "frame_offsets",
                                        "pack", "unpack")),
                       (fk, ("encode_fields", "decode_fields"))):
        for name in names:
            orig = getattr(mod, name)

            def spy(*a, _orig=orig, _name=name, **kw):
                mode = (a[-1] if _name.endswith("_fields") and len(a) > 2
                        else kw.get("fb", kw.get("fb_expect", 0)))
                calls.append((_name, mode))
                return _orig(*a, **kw)
            monkeypatch.setattr(mod, name, spy)
    return calls


def _check_against_fl_jax(data, L):
    bits, values = _enc(data, L)
    jb, jv = fl_jax.encode(data, L)
    np.testing.assert_array_equal(bits, jb)
    np.testing.assert_array_equal(values, jv)
    out = _dec(data.size, bits, values, L)
    np.testing.assert_array_equal(out, fl_jax.decode(data.size, jb, jv, L))
    np.testing.assert_array_equal(out, data)
    return bits, values


TR = fl_torch.PACK_TILE_R


@pytest.mark.parametrize("L", [24, 64, 128])
@pytest.mark.parametrize("kind", ["hit", "miss", "mixed"])
def test_field_route_matches_fl_jax(L, kind, field_route, monkeypatch):
    """A pack-2 hit (every width <= 4), a miss from one width-5 frame in
    the last tile, and random widths 1..8; L = 24 has no pack-2 layout."""
    data = _stream(L, 3 * TR * 512 + 1000 + L // 2, L, 8 if kind == "mixed"
                   else 4)
    if kind == "miss":
        data[-L - 3] = 17                 # one frame of width 5, last tile
    calls = _spy(monkeypatch)
    _check_against_fl_jax(data, L)
    if L == 24:
        want = [("encode_fields", 0), ("decode_fields", 0)]
    elif kind == "hit":
        want = [("encode_fields", TR), ("decode_fields", TR)]
    else:
        want = [("encode_fields", TR), ("encode_fields", 0),
                ("decode_fields", 0)]
    assert calls == want


def test_no_pack2_layout_takes_the_base_kernels(field_route, monkeypatch):
    """L = 1024 has no pack-2 layout (128 % wpf != 0): a stream of widths
    <= 4 takes the base kernels only."""
    data = _stream(5, 200_001, 1024, 4)
    calls = _spy(monkeypatch)
    _check_against_fl_jax(data, 1024)
    assert calls == [("encode_fields", 0), ("decode_fields", 0)]


@pytest.mark.parametrize("L", [64, 128])
def test_chunk_walk_hit_then_miss(L, field_route, monkeypatch):
    """A shrunk chunk cap: a width <= 4 chunk (pack-2 hit), a mixed chunk
    (miss, base re-run) and a tail; each chunk decodes in its own mode.
    The walk is pipelined at depth 2: the second chunk's miss is judged at
    its drain, after the tail has been submitted."""
    cap = 4096 * L
    data = np.concatenate([_stream(6, cap, L, 4), _stream(7, cap, L, 8),
                           _stream(8, 5 * L + 3, L, 4)])
    whole = _enc(data, L)
    monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", cap + L // 2)
    calls = _spy(monkeypatch)
    chunked = _check_against_fl_jax(data, L)
    np.testing.assert_array_equal(chunked[0], whole[0])
    np.testing.assert_array_equal(chunked[1], whole[1])
    assert calls == [("encode_fields", TR), ("encode_fields", TR),
                     ("encode_fields", TR), ("encode_fields", 0),
                     ("decode_fields", TR), ("decode_fields", 0),
                     ("decode_fields", TR)]


@pytest.mark.parametrize("src", GOLDEN_BINS,
                         ids=[os.path.basename(p) for p in GOLDEN_BINS])
def test_field_route_reference_goldens_both_directions(src, field_route):
    data = np.fromfile(src, np.uint8)
    bits, values = _enc(data)
    ref = container.load_fl(src[:-4] + ".fl")
    np.testing.assert_array_equal(bits, ref.bits)
    np.testing.assert_array_equal(values, ref.values)
    np.testing.assert_array_equal(
        _dec(ref.input_size, ref.bits, ref.values), data)


@pytest.fixture
def container16():
    data = np.random.default_rng(0).integers(0, 16, 10_000, np.uint8)
    bits, values = fl_numpy.encode(data)
    return data, bits, values


@pytest.mark.parametrize("corrupt,match", [
    (lambda b, v: (np.where(np.arange(b.size) == 3, 0, b).astype(np.uint8),
                   v), "width byte"),
    (lambda b, v: (np.where(np.arange(b.size) == 3, 9, b).astype(np.uint8),
                   v), "width byte"),
    (lambda b, v: (b, v[:-5]), "payload shorter"),
    (lambda b, v: (b[:10], v), "bits array shorter"),
    (lambda b, v: (b[:0], v), "bits array shorter"),
], ids=["width0", "width9", "short-payload", "short-widths", "no-widths"])
def test_field_route_rejects_corrupt_containers(corrupt, match, container16,
                                                field_route, monkeypatch):
    data, bits, values = container16
    calls = _spy(monkeypatch)
    with pytest.raises(ValueError, match=match):
        _dec(data.size, *corrupt(bits, values))
    assert calls == []


def test_route_switch_is_read_at_each_call(monkeypatch):
    """Without the variable the dense kernels run and no field kernel; with
    it, the reverse."""
    data = _stream(9, 50_000, 128, 8)
    monkeypatch.delenv("FLRL_NO_DENSE", raising=False)
    calls = _spy(monkeypatch)
    comp = _enc(data)
    np.testing.assert_array_equal(_dec(data.size, *comp), data)
    assert calls and all(not c[0].endswith("_fields") for c in calls)
    calls.clear()
    monkeypatch.setenv("FLRL_NO_DENSE", "1")
    for got, want in zip(_enc(data), comp):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_dec(data.size, *comp), data)
    assert calls and all(c[0].endswith("_fields") for c in calls)


def test_host_closed_forms_skip_the_device_on_the_field_route(field_route,
                                                             monkeypatch):
    calls = _spy(monkeypatch)
    const = np.full(10_001, 5, np.uint8)
    np.testing.assert_array_equal(_dec(const.size, *_enc(const)), const)
    w8 = np.random.default_rng(6).integers(128, 256, 5_000).astype(np.uint8)
    np.testing.assert_array_equal(_dec(w8.size, *fl_numpy.encode(w8)), w8)
    assert calls == []


def test_cpu_field_route_launches_no_kernel(field_route):
    before = dict(fk.LAUNCHES)
    data = _stream(10, 60_000, 128, 4)
    np.testing.assert_array_equal(_dec(data.size, *_enc(data)), data)
    assert fk.LAUNCHES == before


def test_wrappers_reject_bad_arguments():
    w = torch.zeros(64, dtype=torch.int32)
    bits, f = fk.encode_fields(w, 128)
    with pytest.raises(ValueError):
        fk.encode_fields(w.to(torch.int64), 128)          # dtype
    with pytest.raises(ValueError):
        fk.encode_fields(w[:48], 128)                      # not whole frames
    with pytest.raises(ValueError):
        fk.encode_fields(w, 12)                            # frame length
    with pytest.raises(ValueError):
        fk.encode_fields(w, 128, 16)                       # not whole tiles
    with pytest.raises(ValueError):
        fk.encode_fields(torch.zeros(16 * 128, dtype=torch.int32), 1024, 16)
    with pytest.raises(ValueError):
        fk.encode_fields(torch.zeros(16 * 128, dtype=torch.int32), 128, 8)
    with pytest.raises(ValueError):
        fk.decode_fields(f[:-1], bits, 128)                # short fields
    with pytest.raises(ValueError):
        fk.decode_fields(f, bits, 128, 16)                 # short slots
    with pytest.raises(ValueError, match="no kernel"):
        fk.encode_fields(torch.zeros(64, dtype=torch.int32, device="meta"),
                         128)
