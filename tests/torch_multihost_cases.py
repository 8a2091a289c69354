"""The cases of ``test_torch_multihost.py``, run on every rank of one
process group (gloo, the CPU): all of them inside one group, so that a
world size pays for its spawn once.  Every case reads the input files the
test wrote under ``root`` and writes its outputs under ``root/w<P>``; rank
0 returns what the files cannot show (verdicts, errors, warnings, the
bytes each round moved) of every rank.  Imports nothing of JAX: spawned
ranks import this module, and the JAX reference runs in the test
process."""

import contextlib
import io
import os
import shutil
import struct
import time

import numpy as np
import torch

from fl_rl_compression_mpi_tpu_torch.parallel import dist
from fl_rl_compression_mpi_tpu_torch.parallel import multihost as mh

CHUNK = 4096              # bytes a round: dozens of rounds on these inputs


def _widths_stream(g, n, L, top):
    frames = -(-n // L)
    w = g.integers(1, top + 1, frames)
    masks = ((1 << w) - 1).astype(np.uint8)
    data = g.integers(0, 256, (frames, L), np.uint8) & masks[:, None]
    data[:, 0] = masks
    return data.reshape(-1)[:n].copy()


def fl_inputs():
    """name -> (data, frame_length): shards that cross frames of mixed
    widths, L = 64, a file smaller than L·P (empty shards), a zero-byte
    file, a constant file (each shard's host closed form)."""
    g = np.random.default_rng(2030)
    return {
        "mixed": (_widths_stream(g, 128 * 400 + 77, 128, 8), 128),
        "L64": (g.integers(0, 64, 64 * 150 + 9, np.uint8), 64),
        "tiny": (g.integers(0, 256, 17, np.uint8), 128),
        "empty": (np.zeros(0, np.uint8), 128),
        "constant": (np.full(128 * 40 + 5, 9, np.uint8), 128),
    }


def rl_inputs():
    g = np.random.default_rng(2031)
    return {
        "runs": np.repeat(g.integers(0, 16, 700, np.uint8), 173),
        "random": g.integers(0, 4, 12_345, np.uint8),
        "tiny": g.integers(0, 3, 17, np.uint8),
        "empty": np.zeros(0, np.uint8),
    }


def bounded_input():
    """The bounded-merge case's input: about 60 rounds of CHUNK bytes."""
    return np.random.default_rng(2032).integers(0, 32, 128 * 3000 + 21,
                                                np.uint8)


def write_inputs(root: str) -> None:
    """Every case's input file under ``root``."""
    for name, (data, _) in fl_inputs().items():
        data.tofile(os.path.join(root, f"{name}.fl.bin"))
    for name, data in rl_inputs().items():
        data.tofile(os.path.join(root, f"{name}.rl.bin"))
    bounded_input().tofile(os.path.join(root, "bounded.bin"))


@contextlib.contextmanager
def env(**values):
    """Environment variables set for the block, restored after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _everyone(value, group):
    """Every rank's ``value``, in rank order."""
    world = dist._rank_world(group)[1]
    if world == 1:
        return [value]
    out = [None] * world
    torch.distributed.all_gather_object(out, value, group=group)
    return out


def _error(fn) -> str:
    try:
        fn()
    except OSError as e:
        return str(e)
    return ""


def _flip_payload_byte(src: str, dst: str) -> None:
    """A copy of the FL container ``src`` with one payload byte flipped:
    it decodes, to other bytes."""
    shutil.copy(src, dst)
    with open(dst, "r+b") as f:
        _, bits_size, _ = struct.unpack("<QQQ", f.read(24))
        f.seek(24 + bits_size + 100)
        b = f.read(1)
        f.seek(24 + bits_size + 100)
        f.write(bytes([b[0] ^ 0xFF]))


def _rewrite_header(src: str, dst: str, fields: tuple, cut: int = 0) -> None:
    """A copy of ``src`` with the header ``fields`` and ``cut`` bytes less
    at the end."""
    with open(src, "rb") as f:
        body = f.read()[24:]
    with open(dst, "wb") as f:
        f.write(struct.pack("<QQQ", *fields))
        f.write(body[:len(body) - cut])


def _corrupt_containers(root: str, out: str, group, device) -> dict:
    """Each corrupt container raises on every rank; rank 0 makes it, and a
    barrier publishes it."""
    mixed_fl = os.path.join(out, "mixed.fl")
    runs_rl = os.path.join(out, "runs.rl")
    with open(mixed_fl, "rb") as f:
        n, bs, vs = struct.unpack("<QQQ", f.read(24))
    with open(runs_rl, "rb") as f:
        rn, rc, rv = struct.unpack("<QQQ", f.read(24))
    bad = {
        # fewer widths than frames
        "fl-widths": ("fl", (n + 128 * bs, bs, vs), 0),
        # a payload shorter than the widths imply
        "fl-payload": ("fl", (n, bs, vs - 1), 1),
        # a width byte of 0: the first payload byte moves into the widths
        "fl-width-byte": ("fl", (n, bs, vs), 0),
        "rl-sizes": ("rl", (rn, rc, rv - 1), 1),
        "rl-sum": ("rl", (rn + 5, rc, rv), 0),
    }
    rank = dist._rank_world(group)[0]
    paths = {}
    for name, (family, fields, cut) in bad.items():
        paths[name] = os.path.join(out, f"{name}.bad")
        if rank == 0:
            _rewrite_header(mixed_fl if family == "fl" else runs_rl,
                            paths[name], fields, cut)
            if name == "fl-width-byte":
                with open(paths[name], "r+b") as f:
                    f.seek(24 + bs // 2)
                    f.write(b"\0")
    mh._barrier(group)
    errors = {}
    for name, (family, _, _) in bad.items():
        dec = mh.decompress_fl_file if family == "fl" else mh.decompress_rl_file
        errors[name] = _everyone(_error(lambda: dec(
            paths[name], paths[name] + ".out", group=group, device=device)),
            group)
    return errors


def _bounded(root: str, out: str, group, device) -> list:
    """The largest tensor each rank sent and received in a round, both
    directions, wrapping the round's batched sends and receives."""
    peak = {"send": 0, "recv": 0}
    posted = mh._post_round

    def tracking(ops):
        for op in ops:
            key = "send" if op.op is torch.distributed.isend else "recv"
            peak[key] = max(peak[key], op.tensor.numel())
        return posted(ops)

    src = os.path.join(root, "bounded.bin")
    dst = os.path.join(out, "bounded.fl")
    mh._post_round = tracking
    try:
        mh.compress_fl_file(src, dst, chunk=CHUNK, group=group,
                            device=device)
        mh.decompress_fl_file(dst, dst + ".out", chunk=CHUNK, group=group,
                              device=device)
    finally:
        mh._post_round = posted
    return _everyone(peak, group)


def _slow_rank0_writes(root: str, out: str, group, device) -> None:
    """Rank 0's pwrites each sleep 0.1 s; every rank round-trips the RL
    container at once, which only the completion barrier makes safe."""
    write = mh._pwrite

    def slow(fd, off, data):
        time.sleep(0.1)
        write(fd, off, data)

    if dist._rank_world(group)[0] == 0:
        mh._pwrite = slow
    try:
        src = os.path.join(root, "runs.rl.bin")
        dst = os.path.join(out, "slow.rl")
        mh.compress_rl_file(src, dst, group=group, device=device)
        mh.decompress_rl_file(dst, dst + ".out", group=group, device=device)
    finally:
        mh._pwrite = write


def run_cases(root: str, *, group=None, device):
    """Every case on this rank; rank 0 returns the per-rank results by
    key, the other ranks None."""
    rank, world = dist._rank_world(group)
    out = os.path.join(root, f"w{world}")
    if rank == 0:
        os.makedirs(out, exist_ok=True)
    mh._barrier(group)
    opts = {"group": group, "device": device}
    res = {}
    for name, (_, L) in fl_inputs().items():
        src = os.path.join(root, f"{name}.fl.bin")
        dst = os.path.join(out, f"{name}.fl")
        mh.compress_fl_file(src, dst, L, chunk=CHUNK, **opts)
        mh.decompress_fl_file(dst, dst + ".out", L, chunk=CHUNK, **opts)
    for name in rl_inputs():
        src = os.path.join(root, f"{name}.rl.bin")
        dst = os.path.join(out, f"{name}.rl")
        mh.compress_rl_file(src, dst, chunk=CHUNK, **opts)
        mh.decompress_rl_file(dst, dst + ".out", chunk=CHUNK, **opts)

    src = os.path.join(root, "mixed.fl.bin")
    good = os.path.join(out, "mixed.fl")
    bad = os.path.join(out, "mixed.fl.flipped")
    if rank == 0:
        _flip_payload_byte(good, bad)
    mh._barrier(group)
    res["verify"] = _everyone(
        (mh.verify_file_roundtrip(src, good, "fl", chunk=CHUNK, **opts),
         mh.verify_file_roundtrip(src, bad, "fl", chunk=CHUNK, **opts)),
        group)
    res["bounded"] = _bounded(root, out, group, device)

    with env(FLRL_SHARED_FS="1"):
        dst = os.path.join(out, "mixed.sfs.fl")
        mh.compress_fl_file(src, dst, **opts)
        mh.decompress_fl_file(dst, dst + ".out", **opts)
        dst = os.path.join(out, "runs.sfs.rl")
        mh.compress_rl_file(os.path.join(root, "runs.rl.bin"), dst, **opts)
        mh.decompress_rl_file(dst, dst + ".out", **opts)

    _slow_rank0_writes(root, out, group, device)

    err = io.StringIO()
    with env(FLRL_SYNTH_CODEC="1"), contextlib.redirect_stderr(err):
        mh.compress_fl_file(src, os.path.join(out, "mixed.synth.fl"),
                            chunk=CHUNK, **opts)
    res["synth"] = _everyone(err.getvalue(), group)

    with env(FLRL_NO_DENSE="1"):
        dst = os.path.join(out, "mixed.fields.fl")
        mh.compress_fl_file(src, dst, chunk=CHUNK, **opts)
        mh.decompress_fl_file(dst, dst + ".out", chunk=CHUNK, **opts)

    res["corrupt"] = _corrupt_containers(root, out, group, device)
    return res if rank == 0 else None
