"""The cases of ``test_torch_dist.py``, run on every rank of one process
group (gloo, the CPU): all of them inside one group, so that a world size
pays for its spawn once.  Imports nothing of JAX: spawned ranks import this
module, and the JAX reference runs in the test process."""

import os
import zlib

import numpy as np
import torch

from fl_rl_compression_mpi_tpu_torch.container import RLCompressed
from fl_rl_compression_mpi_tpu_torch.ops import fl_constant_cuda as ck
from fl_rl_compression_mpi_tpu_torch.parallel import dist

PROBE_TILE_R = 8          # host probe of the constant programs: 4 KiB head


def _widths_stream(g, n, L, top):
    frames = -(-n // L)
    w = g.integers(1, top + 1, frames)
    masks = ((1 << w) - 1).astype(np.uint8)
    data = g.integers(0, 256, (frames, L), np.uint8) & masks[:, None]
    data[:, 0] = masks
    return data.reshape(-1)[:n].copy()


def fl_inputs():
    """(name, data, frame_length): streams that cross shard boundaries,
    streams smaller than L·N (empty shards), the constant closed form."""
    g = np.random.default_rng(2024)
    return [
        ("mixed", _widths_stream(g, 128 * 120 + 77, 128, 8), 128),
        ("low", g.integers(0, 16, 128 * 64 + 5, np.uint8), 128),
        ("uniform", _widths_stream(g, 128 * 90, 128, 1) | 4, 128),
        ("L64", g.integers(0, 64, 9_999, np.uint8), 64),
        ("tiny", g.integers(0, 256, 17, np.uint8), 128),
        ("frame+1", g.integers(0, 256, 129, np.uint8), 128),
        ("constant", np.full(128 * 32 * 3 + 99, 9, np.uint8), 128),
        ("zeros", np.zeros(5_000, np.uint8), 128),
    ]


def rl_inputs():
    g = np.random.default_rng(2025)
    return [
        ("runs", np.repeat(g.integers(0, 8, 200, np.uint8), 300)),
        ("random", g.integers(0, 4, 12_345, np.uint8)),
        ("zeros", np.zeros(128 * 8 * 16, np.uint8)),
        ("tiny", g.integers(0, 3, 17, np.uint8)),
    ]


def constant_inputs(world: int):
    """(cbyte, n) of the device-resident constant programs."""
    return [(0, 128 * 50 * world + 77), (15, 128 * 50 * world)]


ROUTES = ("dense", "fields")


def _set_route(route: str) -> None:
    if route == "fields":
        os.environ["FLRL_NO_DENSE"] = "1"
    else:
        os.environ.pop("FLRL_NO_DENSE", None)


def _same_everywhere(arrays, group) -> bool:
    crc = 0
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return len(set(dist._all_gather_ints([crc], group)[:, 0])) == 1


def _gathered(arrays, group):
    parts = dist._gather_to_rank0([np.asarray(a) for a in arrays], group)
    if parts is None:
        return None
    return [np.concatenate([p[i] for p in parts])
            for i in range(len(arrays))]


def _constant_programs(group, device, world, rank):
    out = {}
    for c, n in constant_inputs(world):
        data = np.full(n, c, np.uint8)
        cb, fb = ck.host_probe_constant(data, n, tile_r=PROBE_TILE_R)
        plan = dist.plan_shards(n, world)
        shard = plan.shard(data, rank).copy()
        x = torch.from_numpy(shard).to(device)
        bits, values, flags = dist.fl_compress_sharded_dense_constant(
            x, cb, fb, group=group)
        back, dflags = dist.fl_decompress_sharded_dense_constant(
            values, values.numel(), shard.size, cb, fb, group=group)
        # a flipped byte in the middle of the stream trips its rank's flag,
        # and every rank sees it
        bad = data.copy()
        bad[n // 2] ^= 0x40
        xb = torch.from_numpy(plan.shard(bad, rank).copy()).to(device)
        _, _, bad_flags = dist.fl_compress_sharded_dense_constant(
            xb, cb, fb, group=group)
        # a flipped payload byte on the last rank trips the decode flag
        vb = values.clone()
        if rank == world - 1 and vb.numel():
            vb[vb.numel() // 2] ^= 0x10
        _, bad_dflags = dist.fl_decompress_sharded_dense_constant(
            vb, vb.numel(), shard.size, cb, fb, group=group)
        got = _gathered([bits.cpu(), values.cpu(), back.cpu()], group)
        flags_all = [f.cpu().numpy() for f in (flags, dflags, bad_flags,
                                               bad_dflags)]
        out[("const", c)] = (got, flags_all,
                             _same_everywhere(flags_all, group))
    return out


def run_cases(*, group=None, device):
    """Every case on this rank; rank 0 returns the results by key, the
    other ranks None."""
    rank, world = dist._rank_world(group)
    saved = os.environ.get("FLRL_NO_DENSE")
    out = {}
    try:
        for route in ROUTES:
            _set_route(route)
            for name, data, L in fl_inputs():
                comp = dist.compress_fl(data, L, group=group, device=device)
                ici = dist.compress_fl_ici(data, L, group=group,
                                           device=device)
                back = dist.decompress_fl(ici, L, group=group, device=device)
                same = _same_everywhere([ici.bits, ici.values], group)
                if rank == 0:
                    out[("fl", name, route)] = (comp.bits, comp.values,
                                                comp.input_size)
                    out[("ici", name, route)] = (ici.bits, ici.values, same)
                    out[("fl_back", name, route)] = back
        _set_route("dense")
        for name, data in rl_inputs():
            comp = dist.compress_rl(data, group=group, device=device)
            # every rank decodes the same container
            sent = _broadcast_rl(comp, group)
            back = dist.decompress_rl(sent, group=group, device=device)
            if rank == 0:
                out[("rl", name)] = (comp.counts, comp.values)
                out[("rl_back", name)] = back
        out.update(_constant_programs(group, device, world, rank))
    finally:
        if saved is None:
            os.environ.pop("FLRL_NO_DENSE", None)
        else:
            os.environ["FLRL_NO_DENSE"] = saved
    return out if rank == 0 else None


def _broadcast_rl(comp, group):
    """Rank 0's RL container on every rank (compress_rl returns it on rank 0
    only)."""
    if dist._rank_world(group)[1] == 1:
        return comp
    box = [None if comp is None else (comp.counts, comp.values,
                                      comp.input_size)]
    torch.distributed.broadcast_object_list(
        box, src=dist._global_rank(group, 0), group=group)
    return RLCompressed(*box[0])


def sharded_inputs():
    """(name, data) of the device-resident programs' group cases: a stream
    of width-4 frames ending mid-frame, frames of random widths, and one
    with fewer bytes than L·N (every shard but the last empty)."""
    g = np.random.default_rng(2026)
    return [("w4", g.integers(0, 16, 128 * 40 + 77, np.uint8)),
            ("mixed", _widths_stream(g, 128 * 33 + 5, 128, 8)),
            ("tiny", g.integers(0, 256, 100, np.uint8))]


def sharded_programs(*, group=None, device):
    """The device-resident programs on this rank's shard of each
    ``sharded_inputs`` stream; rank 0 returns, by name, its gathered
    results (the merged programs', the uniform flags, and whether every
    rank holds the same), and every rank's decodes and runs,
    concatenated; under "local mesh", what ``make_local_mesh`` gives or
    raises on this rank without a device."""
    rank, world = dist._rank_world(group)
    if dist.make_local_mesh(device=device) != (torch.device(device),):
        raise AssertionError("make_local_mesh: not this rank's device")
    try:
        local = repr(dist.make_local_mesh())
    except RuntimeError as e:
        local = f"RuntimeError: {e}"
    out = {"local mesh": local}
    for name, data in sharded_inputs():
        plan = dist.plan_shards(data.size, world)
        n = int(plan.ns[rank])
        x = dist.shard_host_data(data, plan, device=device, group=group)
        bits_g, fields_g = dist.fl_compress_merged(x, group=group)
        merged = dist.fl_compress_merged_dense(x, n, group=group)
        bits, fields = dist.fl_compress_sharded(x)
        back = dist.fl_decompress_sharded(fields, bits)[:n]
        dbits, dense, _ = dist.fl_compress_sharded_dense(x, n)
        dback = dist.fl_decompress_sharded_dense(dense, dbits, n)
        _, _, flags = dist.fl_compress_sharded_dense_uniform(x, n, 4,
                                                             group=group)
        counts, values, runs = dist.rl_compress_sharded(x, n)
        rback = dist.rl_decompress_sharded(counts, values, n)
        r = int(runs[0])
        gathered = [t.cpu().numpy() for t in (bits_g, fields_g, *merged,
                                              flags)]
        same = _same_everywhere(gathered, group)
        mine = _gathered([t.cpu().numpy() for t in (
            back, dback, rback, counts[:r], values[:r])], group)
        if rank == 0:
            out[name] = (gathered, same, mine)
    return out if rank == 0 else None
