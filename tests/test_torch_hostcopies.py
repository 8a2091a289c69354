"""The PyTorch package's copies of the JAX package's framework-free host
modules (container, fileio, native + its C++ source, ops/fl_numpy,
ops/rl_numpy, ops/bitpack, utils.constant_byte_probe, the fl-cpu/rl-cpu
codecs) against their originals, on the fuzz battery and the goldens; and
ops/fields' end-to-end aliases (of fl_torch, on the CPU) against the JAX
module's (of fl_jax).  Tolerance: byte equality throughout."""

import glob
import os

import numpy as np
import pytest

from fl_rl_compression_mpi_tpu import container as j_container
from fl_rl_compression_mpi_tpu import fileio as j_fileio
from fl_rl_compression_mpi_tpu import native as j_native
from fl_rl_compression_mpi_tpu.models import registry as j_registry
from fl_rl_compression_mpi_tpu.ops import bitpack as j_bitpack
from fl_rl_compression_mpi_tpu.ops import fields as j_fields
from fl_rl_compression_mpi_tpu.ops import fl_numpy as j_fl_numpy
from fl_rl_compression_mpi_tpu.ops import rl_numpy as j_rl_numpy
from fl_rl_compression_mpi_tpu.utils import constant_byte_probe as j_probe
from fl_rl_compression_mpi_tpu_torch import container, fileio, native
from fl_rl_compression_mpi_tpu_torch.models import registry
from fl_rl_compression_mpi_tpu_torch.ops import (bitpack, fields, fl_numpy,
                                                 rl_numpy)
from fl_rl_compression_mpi_tpu_torch.utils import constant_byte_probe
from fuzz_battery import battery

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _inputs():
    cases = [(f"battery{i}", d) for i, d in enumerate(battery())]
    for path in sorted(glob.glob(os.path.join(GOLDEN, "reference", "*.bin"))
                       + [os.path.join(GOLDEN, "input.bin")]):
        cases.append((os.path.basename(path)[:-4],
                      np.fromfile(path, np.uint8)))
    return cases


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def check_container(data, tmp):
    bits, values = j_fl_numpy.encode(data)
    counts, rvalues = j_rl_numpy.encode(data)
    for family, ours, theirs in (
            ("fl", container.FLCompressed(bits, values, data.size),
             j_container.FLCompressed(bits, values, data.size)),
            ("rl", container.RLCompressed(counts, rvalues, data.size),
             j_container.RLCompressed(counts, rvalues, data.size))):
        a, b = str(tmp / f"ours.{family}"), str(tmp / f"theirs.{family}")
        getattr(container, f"save_{family}")(a, ours)
        getattr(j_container, f"save_{family}")(b, theirs)
        assert _read(a) == _read(b)
        back = getattr(container, f"load_{family}")(b)
        want = getattr(j_container, f"load_{family}")(a)
        for f in ("input_size",) + (("bits", "values") if family == "fl"
                                    else ("counts", "values")):
            _eq(getattr(back, f), getattr(want, f))
    merged = container.FLCompressed(bits, values, data.size).merge(
        container.FLCompressed(bits, values, data.size))
    j_merged = j_container.FLCompressed(bits, values, data.size).merge(
        j_container.FLCompressed(bits, values, data.size))
    _eq(merged.values, j_merged.values)
    assert merged.input_size == j_merged.input_size


def check_fileio(data, tmp):
    a, b = str(tmp / "a.bin"), str(tmp / "b.bin")
    fileio.save_file(a, data)
    j_fileio.save_file(b, data)
    assert _read(a) == _read(b)
    _eq(fileio.load_file(b), j_fileio.load_file(a))
    off = data.size // 3
    _eq(fileio.load_range(a, off, data.size - off),
        j_fileio.load_range(a, off, data.size - off))
    for shard in range(3):
        got, goff = fileio.load_file_sharded(a, shard, 3)
        want, woff = j_fileio.load_file_sharded(a, shard, 3)
        _eq(got, want)
        assert goff == woff


def _natives():
    ours, theirs = native.get_native(), j_native.get_native()
    assert ours is not None and theirs is not None, "native library missing"
    return ours, theirs


def check_native_fl(data, tmp):
    ours, theirs = _natives()
    for L in (64, 128):
        bits, values = ours.fl_encode(data, L)
        jb, jv = theirs.fl_encode(data, L)
        _eq(bits, jb)
        _eq(values, jv)
        if data.size:
            _eq(ours.fl_decode(data.size, jb, jv, L), data)
            _eq(ours.fl_decode(data.size, jb, jv, L),
                theirs.fl_decode(data.size, bits, values, L))


def check_native_rl(data, tmp):
    ours, theirs = _natives()
    counts, values = ours.rl_encode(data)
    jc, jv = theirs.rl_encode(data)
    _eq(counts, jc)
    _eq(values, jv)
    _eq(ours.rl_decode(jc, jv), theirs.rl_decode(counts, values))


def check_native_fold(data, tmp):
    ours, theirs = _natives()
    if data.size == 0:
        return
    L = 128
    bits, values = j_fl_numpy.encode(data, L)
    fields = ours.fl_unfold(values, bits, data.size, L)
    _eq(fields, theirs.fl_unfold(values, bits, data.size, L))
    _eq(ours.fl_fold(fields, bits, data.size, L),
        theirs.fl_fold(fields, bits, data.size, L))
    low = data & 15                     # every width <= 4: pack-2 defined
    bits, values = j_fl_numpy.encode(low, L)
    words = -(-(bits.size * 32) // (16 * 128)) * (16 * 128 // 2)
    packed = ours.fl_unfold_p2(values, bits, low.size, L, 16, words)
    _eq(packed, theirs.fl_unfold_p2(values, bits, low.size, L, 16, words))
    _eq(ours.fl_fold_p2(packed, bits, low.size, L, 16),
        theirs.fl_fold_p2(packed, bits, low.size, L, 16))


def check_fl_numpy(data, tmp):
    for L in (8, 128):
        bits, values = fl_numpy.encode(data, L)
        jb, jv = j_fl_numpy.encode(data, L)
        _eq(bits, jb)
        _eq(values, jv)
        _eq(fl_numpy.decode(data.size, jb, jv, L),
            j_fl_numpy.decode(data.size, bits, values, L))
        assert fl_numpy.compressed_size(data, L) == \
            j_fl_numpy.compressed_size(data, L)
    if data.size <= 4096:
        sb, sv = fl_numpy.encode_seq(data)
        _eq(sb, j_fl_numpy.encode_seq(data)[0])
        _eq(fl_numpy.decode_seq(data.size, sb, sv),
            j_fl_numpy.decode_seq(data.size, sb, sv))


def check_rl_numpy(data, tmp):
    counts, values = rl_numpy.encode(data)
    jc, jv = j_rl_numpy.encode(data)
    _eq(counts, jc)
    _eq(values, jv)
    _eq(rl_numpy.decode(jc, jv), j_rl_numpy.decode(counts, values))
    assert rl_numpy.compressed_size(data) == j_rl_numpy.compressed_size(data)
    if data.size <= 4096:
        _eq(rl_numpy.encode_seq(data)[0], j_rl_numpy.encode_seq(data)[0])


def check_constant_probe(data, tmp):
    assert constant_byte_probe(data) == j_probe(data)
    if data.size:
        const = np.full(data.size, data[0], np.uint8)
        assert constant_byte_probe(const) == j_probe(const) == int(data[0])


def check_cpu_codecs(data, tmp):
    for name in ("fl-cpu", "rl-cpu"):
        ours = registry.CODECS[name].compress(data)
        theirs = j_registry.CODECS[name].compress(data)
        fields = (("bits", "values") if name == "fl-cpu"
                  else ("counts", "values"))
        for f in fields + ("input_size",):
            _eq(getattr(ours, f), getattr(theirs, f))
        _eq(registry.CODECS[name].decompress(theirs),
            j_registry.CODECS[name].decompress(ours))


def check_bitpack(data, tmp):
    """The widths of the input's bytes, and the pack tables at a frame
    length taken from its size (a multiple of 8 below 1024)."""
    L = max(8, data.size // 8 * 8 % 1024)
    assert bitpack.FRAME_LENGTH == j_bitpack.FRAME_LENGTH
    assert bitpack.MAX_WIDTH == j_bitpack.MAX_WIDTH
    _eq(bitpack.required_bits_u8(data), j_bitpack.required_bits_u8(data))
    assert bitpack.max_row_bytes(L) == j_bitpack.max_row_bytes(L)
    for b in range(1, 9):
        assert bitpack.packed_bytes(L, b) == j_bitpack.packed_bytes(L, b)
        for x, y in zip(bitpack.pack_tables(L)[b],
                        j_bitpack.pack_tables(L)[b]):
            _eq(x, y)
        for x, y in zip(bitpack.unpack_tables(L)[b],
                        j_bitpack.unpack_tables(L)[b]):
            _eq(x, y)


def check_fields_aliases(data, tmp):
    """``fields.encode``/``decode`` (fl_torch on the CPU) against the JAX
    module's (fl_jax), each decoding the other's container."""
    for L in (64, 128):
        bits, values = fields.encode(data, L, device="cpu")
        jb, jv = j_fields.encode(data, L)
        _eq(bits, jb)
        _eq(values, jv)
        _eq(fields.decode(data.size, jb, jv, L, device="cpu"),
            j_fields.decode(data.size, bits, values, L))


CHECKS = [check_container, check_fileio, check_native_fl, check_native_rl,
          check_native_fold, check_fl_numpy, check_rl_numpy,
          check_constant_probe, check_cpu_codecs, check_bitpack,
          check_fields_aliases]
INPUTS = _inputs()


@pytest.mark.parametrize("check", CHECKS,
                         ids=[c.__name__[6:] for c in CHECKS])
@pytest.mark.parametrize("name,data", INPUTS, ids=[n for n, _ in INPUTS])
def test_copy_matches_jax_original(check, name, data, tmp_path):
    check(data, tmp_path)


def test_native_library_is_the_packages_own():
    """The copy builds its own library from its own source, beside the
    package, and the port's modules use it."""
    ours, theirs = _natives()
    assert ours is not theirs
    assert native._SRC_PATH.startswith(os.path.dirname(native.__file__))
    assert native._SO_PATH.startswith(os.path.dirname(native.__file__))
    # the same code; only a comment's path to the reference differs
    with open(native._SRC_PATH) as a, open(j_native._SRC_PATH) as b:
        assert _code_lines(a.read()) == _code_lines(b.read())


def _code_lines(source: str) -> list:
    return [line for line in source.splitlines()
            if not line.lstrip().startswith("//")]
