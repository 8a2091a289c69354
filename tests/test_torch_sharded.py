"""The device-resident sharded programs of ``parallel/dist.py`` on the CPU.

Each program runs on a mesh of N = 1, 2, 3 and 4 CPU shards
(``dist.make_mesh(N, "cpu")``), its inputs put there by
``dist.shard_host_data``, and is held against the JAX package's program of
the same name on ``make_mesh(N)`` of the virtual CPU devices (the field
and RL programs run its XLA kernels; the dense ones its Pallas kernels in
interpret mode at 8-row tiles, as its own tests run them), and against
``fl_numpy``/``rl_numpy`` of each shard.  The streams are the fuzz
battery's classes (most end mid-frame; several hold fewer bytes than L·N,
so that shards are empty) and one at L = 64.  The group form runs on two
gloo ranks spawned by ``dist.spawn_group`` (``torch_dist_cases``).
Tolerance: byte equality throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from fuzz_battery import battery
from fl_rl_compression_mpi_tpu.ops import fl_dense_pallas, fl_numpy, rl_numpy
from fl_rl_compression_mpi_tpu.parallel import dist as jdist
from fl_rl_compression_mpi_tpu_torch.ops import rl_cuda, rl_torch
from fl_rl_compression_mpi_tpu_torch.parallel import dist

CPU = torch.device("cpu")
SHARDS = (1, 2, 3, 4)
L = 128


def _streams():
    """(name, data, frame_length): the fuzz battery's classes, each once,
    and a mid-frame stream at L = 64."""
    keep = {1: "one-zero", 2: "one-255", 4: "zeros-129", 5: "ones-127",
            8: "bits-1024", 9: "w4-1000", 10: "random-909", 12: "runs-3000",
            16: "sevens-511", 18: "runs-then-random", 19: "ramp-1280",
            21: "three-regions", 0: "empty"}
    data = battery()
    g = np.random.default_rng(64)
    return ([(name, data[i], L) for i, name in sorted(keep.items())]
            + [("L64", g.integers(0, 64, 64 * 37 + 21, np.uint8), 64)])


STREAMS = {name: (data, fl) for name, data, fl in _streams()}
IDS = [(n, name) for n in SHARDS for name in STREAMS]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _port(name: str, n: int, fl: int | None = None):
    """The mesh, the plan and the shards of stream ``name`` at N = n, split
    at its frame length or at ``fl``."""
    data, fl = STREAMS[name][0], fl or STREAMS[name][1]
    mesh = dist.make_mesh(n, CPU)
    plan = dist.plan_shards(data.size, n, fl)
    return data, fl, mesh, plan, dist.shard_host_data(data, plan, mesh)


def _jax_words(data, n: int, fl: int, **kw):
    plan = jdist.plan_shards(data.size, n, fl, **kw)
    return plan, jdist.shard_host_data(data, plan)


def _frames(m, fl=L) -> int:
    return -(-int(m) // fl)


def test_shard_npad_and_shard_host_data():
    """A whole number of frames and of 16 bytes, at least the largest
    shard; each buffer holds its shard, then zeros, on its device."""
    for total, n, fl in ((10_000, 3, 128), (17, 4, 128), (0, 2, 128),
                         (999, 2, 24)):
        plan = dist.plan_shards(total, n, fl)
        npad = plan.shard_npad
        assert npad % fl == 0 and npad % 16 == 0 and npad >= plan.ns.max()
        assert npad - max(int(plan.ns.max()), 1) < np.lcm(fl, 16)
        data = np.random.default_rng(total).integers(1, 256, total, np.uint8)
        mesh = dist.make_mesh(n, CPU)
        xs = dist.shard_host_data(data, plan, mesh)
        for i, x in enumerate(xs):
            assert x.dtype == torch.uint8 and x.shape == (npad,)
            m = int(plan.ns[i])
            _eq(_np(x[:m]), plan.shard(data, i))
            assert not x[m:].any()
    assert dist.make_local_mesh(3, CPU) == (CPU,) * 3
    with pytest.raises(ValueError, match="shards for a mesh"):
        dist.shard_host_data(data, plan, dist.make_mesh(1, CPU))


@pytest.mark.parametrize("n,name", IDS, ids=[f"n{n}-{s}" for n, s in IDS])
def test_field_programs_equal_jax(n, name):
    """fl_compress_sharded's widths and fields, fl_compress_merged's
    gathered copies (the same on every device) and fl_decompress_sharded's
    bytes equal the JAX programs' at the same N."""
    data, fl, mesh, plan, xs = _port(name, n)
    bits, fields = dist.fl_compress_sharded(xs, fl, mesh=mesh)
    bits_g, fields_g = dist.fl_compress_merged(xs, fl, mesh=mesh)
    out = dist.fl_decompress_sharded(fields, bits, fl, mesh=mesh)
    jplan, words = _jax_words(data, n, fl)
    jmesh = jdist.make_mesh(n)
    ns = jnp.asarray(jplan.ns, jnp.int32)
    words = jnp.asarray(words.view(np.uint32))
    jb, jf = jax.device_get(jdist.fl_compress_sharded(jmesh, words, ns, fl))
    jbg, jfg = jax.device_get(jdist.fl_compress_merged(jmesh, words, ns, fl))
    jout = jax.device_get(jdist.fl_decompress_sharded(
        jmesh, jnp.asarray(jf), jnp.asarray(jb), ns, fl))
    F, nw = plan.shard_npad // fl, plan.shard_npad // 4
    for i in range(n):
        assert bits[i].shape == (F,) and fields[i].shape == (nw,)
        _eq(_np(bits[i]), np.asarray(jb)[i, :F])
        _eq(_np(fields[i]).view(np.uint32), np.asarray(jf)[i, :nw])
        m = int(plan.ns[i])
        _eq(_np(out[i][:m]), plan.shard(data, i))
        _eq(_np(out[i][:m]),
            np.ascontiguousarray(np.asarray(jout)[i]).view(np.uint8)[:m])
    for d, dev in enumerate(mesh):
        assert bits_g[d].device == dev and fields_g[d].device == dev
        _eq(_np(bits_g[d]), np.asarray(jbg)[:, :F])
        _eq(_np(fields_g[d]).view(np.uint32), np.asarray(jfg)[:, :nw])


@pytest.mark.parametrize("n,name", IDS, ids=[f"n{n}-{s}" for n, s in IDS])
def test_rl_programs_equal_jax(n, name):
    """rl_compress_sharded's run counts and runs equal the JAX program's
    and rl_numpy's of each shard; the counts past the runs are zero; the
    decode restores every shard."""
    data, _, mesh, plan, xs = _port(name, n, L)     # RL splits at L = 128
    counts, values, runs = dist.rl_compress_sharded(xs, plan.ns, mesh=mesh)
    out = dist.rl_decompress_sharded(counts, values, plan.ns, mesh=mesh)
    jplan, rows = _jax_words(data, n, L)
    jc, jv, jr = jax.device_get(jdist.rl_compress_sharded(
        jdist.make_mesh(n), jnp.asarray(rows),
        jnp.asarray(jplan.ns, jnp.int32)))
    for i in range(n):
        r = int(runs[i][0])
        assert r == int(jr[i])
        _eq(_np(counts[i][:r]), np.asarray(jc)[i, :r])
        _eq(_np(values[i][:r]), np.asarray(jv)[i, :r])
        want_c, want_v = rl_numpy.encode(plan.shard(data, i))
        _eq(_np(counts[i][:r]), want_c)
        _eq(_np(values[i][:r]), want_v)
        assert counts[i].shape == (int(plan.ns[i]),)
        assert not counts[i][r:].any()
        _eq(_np(out[i]), plan.shard(data, i))


@pytest.mark.parametrize("n,name", IDS, ids=[f"n{n}-{s}" for n, s in IDS])
def test_dense_programs_equal_fl_numpy(n, name):
    """fl_compress_sharded_dense's widths, payload prefix and size are
    fl_numpy's container of each shard; fl_compress_merged_dense's is the
    whole stream's, on every device; the decode restores every shard."""
    data, fl, mesh, plan, xs = _port(name, n)
    bits, dense, totals = dist.fl_compress_sharded_dense(xs, plan.ns, fl,
                                                         mesh=mesh)
    out = dist.fl_decompress_sharded_dense(dense, bits, plan.ns, fl,
                                           mesh=mesh)
    mbits, mvalues, mtotals = dist.fl_compress_merged_dense(
        xs, plan.ns, fl, mesh=mesh)
    sizes = []
    for i in range(n):
        want_b, want_v = fl_numpy.encode(plan.shard(data, i), fl)
        _eq(_np(bits[i]), want_b)
        assert int(totals[i][0]) == want_v.size
        assert dense[i].shape == (plan.shard_npad,)
        _eq(_np(dense[i][:want_v.size]), want_v)
        _eq(_np(out[i]), plan.shard(data, i))
        sizes.append(want_v.size)
    want_b, want_v = fl_numpy.encode(data, fl)
    for d, dev in enumerate(mesh):
        assert mbits[d].device == dev
        _eq(_np(mbits[d]), want_b)
        _eq(_np(mvalues[d]), want_v)
        _eq(_np(mtotals[d]), sizes)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("fb", (1, 4, 8))
def test_uniform_programs_and_their_flags(n, fb):
    """The single-width programs on a stream of width-fb frames that ends
    mid-frame: every flag clean, fl_numpy's container per shard, the decode
    exact; on a stream with one frame of another width in the last shard,
    that shard's flag alone is raised."""
    g = np.random.default_rng(fb)
    hi = 1 << fb
    data = g.integers(0, hi, 128 * 23 * n + 77).astype(np.uint8)
    data[::128] = hi - 1
    mesh = dist.make_mesh(n, CPU)
    plan = dist.plan_shards(data.size, n)
    xs = dist.shard_host_data(data, plan, mesh)
    bits, dense, flags = dist.fl_compress_sharded_dense_uniform(
        xs, plan.ns, fb, mesh=mesh)
    assert flags.tolist() == [0] * n
    out = dist.fl_decompress_sharded_dense_uniform(dense, plan.ns, fb,
                                                   mesh=mesh)
    for i in range(n):
        want_b, want_v = fl_numpy.encode(plan.shard(data, i))
        _eq(_np(bits[i]), want_b)
        _eq(_np(dense[i]), want_v)
        _eq(_np(out[i]), plan.shard(data, i))
    bad = data.copy()
    last = (data.size - 1) // 128 * 128     # the last frame, in the last shard
    if fb < 8:
        bad[last] = 0xFF                    # width 8
    else:
        bad[last:] = 1                      # width 1
    xb = dist.shard_host_data(bad, plan, mesh)
    _, _, bad_flags = dist.fl_compress_sharded_dense_uniform(
        xb, plan.ns, fb, mesh=mesh)
    assert bad_flags.tolist() == [0] * (n - 1) + [1]


# The JAX package's dense programs run its Pallas kernels, here in
# interpret mode at 8-row tiles (``test_distributed.py`` runs them so):
# one stream, N = 1..4.
R = 8
DENSE_STREAM = np.random.default_rng(77).integers(0, 64, 128 * 45 + 77,
                                                  np.uint8)


@pytest.fixture
def small_tiles(monkeypatch):
    for tile in ("DENSE_TILE_R", "DENSE_DEC_TILE_R", "DENSE_UNIFORM_TILE_R"):
        monkeypatch.setattr(fl_dense_pallas, tile, R)


def _jax_dense(data, n):
    plan, words = _jax_words(data, n, L, bucket_frames=R)
    nfs = jnp.asarray([_frames(m) for m in plan.ns], jnp.int32)
    return plan, jnp.asarray(words.view(np.uint32)), nfs


@pytest.mark.parametrize("n", SHARDS)
def test_dense_programs_equal_jax(n, small_tiles):
    """fl_compress_sharded_dense, fl_compress_merged_dense and
    fl_decompress_sharded_dense against the JAX programs at the same N:
    each shard's widths and payload prefix, every shard's gathered onto
    every device, and the decoded bytes."""
    data = DENSE_STREAM
    mesh = dist.make_mesh(n, CPU)
    plan = dist.plan_shards(data.size, n)
    xs = dist.shard_host_data(data, plan, mesh)
    bits, dense, totals = dist.fl_compress_sharded_dense(xs, plan.ns,
                                                         mesh=mesh)
    mbits, mvalues, _ = dist.fl_compress_merged_dense(xs, plan.ns,
                                                      mesh=mesh)
    out = dist.fl_decompress_sharded_dense(dense, bits, plan.ns, mesh=mesh)
    jplan, words, nfs = _jax_dense(data, n)
    jmesh = jdist.make_mesh(n)
    jb, jd, _, jflags = jax.device_get(
        jdist.fl_compress_sharded_dense(jmesh, words, nfs))
    jbg, jdg, jtg = jax.device_get(
        jdist.fl_compress_merged_dense(jmesh, words, nfs))
    assert int(np.asarray(jflags).sum()) == 0
    rows = jplan.shard_npad // 512
    grid = rows // R
    dense3d = np.zeros((n, rows + R + 32, 128), np.uint32)
    bits3d = np.zeros((n, rows, 4), np.uint8)
    woffs = np.zeros((n, grid), np.int32)
    for i in range(n):
        f, t = _frames(plan.ns[i]), int(totals[i][0])
        _eq(_np(bits[i]), np.asarray(jb)[i].reshape(-1)[:f])
        _eq(_np(dense[i][:t]), np.asarray(jd)[i].view(np.uint8)[:t])
        _eq(np.asarray(jbg)[i].reshape(-1)[:f], _np(bits[i]))
        _eq(np.asarray(jdg)[i].view(np.uint8)[:t], _np(dense[i][:t]))
        dense3d[i].reshape(-1).view(np.uint8)[:t] = _np(dense[i][:t])
        bits3d[i].reshape(-1)[:f] = _np(bits[i])
        fw = np.zeros(rows * 4, np.int64)
        fw[:f] = _np(bits[i])
        woffs[i] = np.concatenate(
            [[0], np.cumsum(fw.reshape(grid, -1).sum(1) * 4)[:-1]])
    jout = jax.device_get(jdist.fl_decompress_sharded_dense(
        jmesh, jnp.asarray(dense3d), jnp.asarray(bits3d),
        jnp.asarray(woffs), nfs))
    jout = np.ascontiguousarray(np.asarray(jout)).view(np.uint8).reshape(
        n, -1)
    for i in range(n):
        _eq(_np(out[i]), jout[i, :int(plan.ns[i])])
    want_b, want_v = fl_numpy.encode(data)
    for d in range(n):
        _eq(_np(mbits[d]), want_b)
        _eq(_np(mvalues[d]), want_v)


@pytest.mark.parametrize("n", SHARDS)
def test_uniform_programs_equal_jax(n, small_tiles):
    """fl_compress_sharded_dense_uniform and its decode against the JAX
    programs at the same N on width-4 frames: flags, payloads, bytes."""
    fb = 4
    data = (DENSE_STREAM & 15) | 8
    mesh = dist.make_mesh(n, CPU)
    plan = dist.plan_shards(data.size, n)
    xs = dist.shard_host_data(data, plan, mesh)
    _, dense, flags = dist.fl_compress_sharded_dense_uniform(
        xs, plan.ns, fb, mesh=mesh)
    out = dist.fl_decompress_sharded_dense_uniform(dense, plan.ns, fb,
                                                   mesh=mesh)
    jplan, words, nfs = _jax_dense(data, n)
    jmesh = jdist.make_mesh(n)
    _, jd, jflags = jax.device_get(jdist.fl_compress_sharded_dense_uniform(
        jmesh, words, nfs, fb, tile_r=R))
    _eq(flags.numpy(), np.asarray(jflags).reshape(-1))
    rows = jplan.shard_npad // 512
    dense3d = np.zeros((n, rows // R * (fb * R // 8), 128), np.uint32)
    for i in range(n):
        v = _np(dense[i])
        _eq(v, np.asarray(jd)[i].reshape(-1).view(np.uint8)[:v.size])
        dense3d[i].reshape(-1).view(np.uint8)[:v.size] = v
    jout = jax.device_get(jdist.fl_decompress_sharded_dense_uniform(
        jmesh, jnp.asarray(dense3d), nfs, fb, rows, tile_r=R))
    jout = np.ascontiguousarray(np.asarray(jout)).view(np.uint8).reshape(
        n, -1)
    for i in range(n):
        _eq(_np(out[i]), jout[i, :int(plan.ns[i])])
        _eq(_np(out[i]), plan.shard(data, i))


_GROUP: dict = {}
GROUP_NAMES = [name for name, _ in cases.sharded_inputs()]


def _group():
    if not _GROUP:
        _GROUP.update(dist.spawn_group(cases.sharded_programs, world=2,
                                       device=CPU))
    return _GROUP


@pytest.mark.parametrize("name", GROUP_NAMES)
def test_group_programs_on_two_ranks(name):
    """Two gloo ranks, each with its own shard: fl_compress_merged's and
    fl_compress_merged_dense's gathered tensors are the same on both ranks
    and equal the two-shard mesh's; the uniform flags are gathered; each
    rank's decodes restore its shard and its runs are rl_numpy's."""
    data = dict(cases.sharded_inputs())[name]
    (bits_g, fields_g, mbits, mvalues, mtotals, flags), same, mine = \
        _group()[name]
    assert same
    mesh = dist.make_mesh(2, CPU)
    plan = dist.plan_shards(data.size, 2)
    xs = dist.shard_host_data(data, plan, mesh)
    want_bg, want_fg = dist.fl_compress_merged(xs, mesh=mesh)
    _eq(bits_g, _np(want_bg[0]))
    _eq(fields_g, _np(want_fg[0]))
    want_b, want_v = fl_numpy.encode(data)
    _eq(mbits, want_b)
    _eq(mvalues, want_v)
    _eq(mtotals, [fl_numpy.encode(plan.shard(data, i))[1].size
                  for i in range(2)])
    _, _, want_flags = dist.fl_compress_sharded_dense_uniform(
        xs, plan.ns, 4, mesh=mesh)
    _eq(flags, want_flags.numpy())
    back, dback, rback, counts, values = mine
    for got in (back, dback, rback):
        _eq(got, data)
    parts = [rl_numpy.encode(plan.shard(data, i)) for i in range(2)]
    _eq(counts, np.concatenate([p[0] for p in parts]))
    _eq(values, np.concatenate([p[1] for p in parts]))


def test_make_local_mesh_on_a_rank_without_a_device():
    """On a rank of a process group, make_local_mesh with no device is the
    rank's card (``multihost.local_device``); with no card it raises a
    RuntimeError that says to pass one."""
    local = _group()["local mesh"]
    if torch.cuda.is_available():
        assert local == repr((torch.device("cuda", 0),))     # rank 0's
    else:
        assert local.startswith("RuntimeError: make_local_mesh: no CUDA "
                                "device for this rank; pass device=")


def test_a_shard_over_a_kernel_limit_or_on_another_device_raises():
    """A shard larger than one launch takes raises, naming the limit
    (nothing is touched: the buffers stay unwritten); a shard on another
    device than its mesh entry raises."""
    mesh = dist.make_mesh(1, CPU)
    big = 1 << 31
    words = [torch.empty(big // 4 + 4, dtype=torch.int32)]
    with pytest.raises(ValueError, match=r"2\^31"):
        dist.fl_compress_sharded(words, mesh=mesh)
    x = [words[0].view(torch.uint8)]
    with pytest.raises(ValueError, match=r"2\^31"):
        dist.fl_compress_sharded_dense(x, [big + 16], mesh=mesh)
    with pytest.raises(ValueError, match=r"2\^31"):
        dist.fl_compress_sharded_dense_uniform(x, [big + 16], 4, mesh=mesh)
    with pytest.raises(ValueError, match=r"2\^30"):
        dist.rl_compress_sharded(x, [(1 << 30) + 16], mesh=mesh)
    with pytest.raises(ValueError, match=r"2\^30"):
        rl_cuda.encode_device(x[0][:(1 << 30) + 16])
    del words, x
    small = torch.zeros(256, dtype=torch.uint8)
    with pytest.raises(ValueError, match="lies on"):
        dist.fl_compress_sharded([small, small.to("meta")],
                                 mesh=dist.make_mesh(2, CPU))
    with pytest.raises(ValueError, match="2 shards for a mesh of 1"):
        dist.rl_compress_sharded([small, small], [1, 1], mesh=mesh)


def test_rl_device_pieces_leave_zero_counts_past_the_runs():
    """rl_torch.encode_device gives u8[n] counts whose tail past num_runs
    is zero, and decode_device of all of them is the stream, with u8[n]
    for any n (zeros past the runs on the CPU)."""
    data = np.repeat(np.arange(40, dtype=np.uint8), 300)[:10_000].copy()
    x = torch.from_numpy(data)
    counts, values, runs = rl_torch.encode_device(x)
    r = int(runs[0])
    want_c, want_v = rl_numpy.encode(data)
    assert r == want_c.size and counts.shape == (data.size,)
    _eq(_np(counts[:r]), want_c)
    _eq(_np(values[:r]), want_v)
    assert not counts[r:].any()
    _eq(_np(rl_torch.decode_device(counts, values, data.size)), data)
    longer = rl_torch.decode_device(counts, values, data.size + 7)
    _eq(_np(longer[:data.size]), data)
    assert longer.shape == (data.size + 7,)
