"""``parallel/dist.py``'s process-group path on gloo (the CPU): in this
process with no group at world size 1, and at 2 and 3 ranks one group a
world size, spawned by ``dist.spawn_group``, every case run inside it
(``torch_dist_cases.run_cases``).  The results are held against the JAX
package's ``parallel.dist`` on a sub-mesh of the same number of virtual CPU
devices and against ``fl_numpy``/``rl_numpy``.  The one-process mesh path
has its own tests (``test_torch_mesh.py``).  Tolerance: byte equality
throughout."""

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from fl_rl_compression_mpi_tpu.ops import fl_numpy, rl_numpy
from fl_rl_compression_mpi_tpu.parallel import dist as jdist
from fl_rl_compression_mpi_tpu_torch.parallel import dist

WORLDS = (1, 2, 3)
FL = {name: (data, L) for name, data, L in cases.fl_inputs()}
RL = dict(cases.rl_inputs())
FL_IDS = [(w, name, route) for w in WORLDS for name in FL
          for route in cases.ROUTES]
RL_IDS = [(w, name) for w in WORLDS for name in RL]
_RESULTS: dict = {}


def results(world: int) -> dict:
    """Rank 0's results of every case at ``world`` ranks, computed once."""
    if world not in _RESULTS:
        cpu = torch.device("cpu")
        _RESULTS[world] = (cases.run_cases(device=cpu) if world == 1 else
                           dist.spawn_group(cases.run_cases, world=world,
                                            device=cpu))
    return _RESULTS[world]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_plan_shards_reference_split_rule():
    for total, n in ((1_000_000, 8), (1_000_000, 3), (17, 3), (0, 2)):
        plan = dist.plan_shards(total, n)
        want = jdist.plan_shards(total, n, bucket_frames=8)
        _eq(plan.ns, want.ns)
        assert plan.ns.sum() == total
        assert all(x % 128 == 0 for x in plan.ns[:-1])
        _eq(plan.starts, np.concatenate([[0], np.cumsum(plan.ns)[:-1]]))


@pytest.mark.parametrize("world,name,route", FL_IDS,
                         ids=[f"w{w}-{n}-{r}" for w, n, r in FL_IDS])
def test_fl_dist_and_ici_equal_jax_and_fl_numpy(world, name, route):
    """fl-dist and fl-ici containers (each route per shard) equal the JAX
    package's dist.compress_fl / compress_fl_ici at the same N and
    fl_numpy's; fl-ici's is the same on every rank; the round trip is
    exact."""
    data, L = FL[name]
    got = results(world)
    bits, values, size = got[("fl", name, route)]
    ibits, ivalues, same = got[("ici", name, route)]
    want_b, want_v = fl_numpy.encode(data, L)
    _eq(bits, want_b)
    _eq(values, want_v)
    _eq(ibits, want_b)
    _eq(ivalues, want_v)
    assert size == data.size and same
    _eq(got[("fl_back", name, route)], data)
    if route == "dense":            # the JAX side has no route switch
        mesh = jdist.make_mesh(world)
        j = jdist.compress_fl(data, mesh, L, bucket_frames=64)
        ji = jdist.compress_fl_ici(data, mesh, L, bucket_frames=64)
        _eq(bits, j.bits)
        _eq(values, j.values)
        _eq(ibits, ji.bits)
        _eq(ivalues, ji.values)


@pytest.mark.parametrize("world,name", RL_IDS,
                         ids=[f"w{w}-{n}" for w, n in RL_IDS])
def test_rl_dist_equals_jax_at_the_same_n(world, name):
    """rl-dist's container equals the JAX package's dist.compress_rl at the
    same N, and the concatenation of rl_numpy's per-shard containers; the
    round trip is exact."""
    data = RL[name]
    counts, values = results(world)[("rl", name)]
    j = jdist.compress_rl(data, jdist.make_mesh(world), bucket_frames=64)
    _eq(counts, j.counts)
    _eq(values, j.values)
    plan = dist.plan_shards(data.size, world)
    parts = [rl_numpy.encode(plan.shard(data, i)) for i in range(world)]
    _eq(counts, np.concatenate([p[0] for p in parts]))
    _eq(values, np.concatenate([p[1] for p in parts]))
    _eq(results(world)[("rl_back", name)], data)


CONST_IDS = [(w, c) for w in WORLDS for c, _ in cases.constant_inputs(1)]


@pytest.mark.parametrize("world,c", CONST_IDS,
                         ids=[f"w{w}-c{c}" for w, c in CONST_IDS])
def test_constant_programs_and_their_flags(world, c):
    """The device-resident constant programs: each rank's widths and
    payload, concatenated, are fl_numpy's container; decode restores every
    shard; the flags, gathered to every rank, are clean, and trip on a
    flipped input byte and on a flipped payload byte."""
    n = dict(cases.constant_inputs(world))[c]
    data = np.full(n, c, np.uint8)
    (bits, values, back), flags, same = results(world)[("const", c)]
    want_b, want_v = fl_numpy.encode(data)
    _eq(bits, want_b)
    _eq(values, want_v)
    _eq(back, data)
    enc, dec, bad_enc, bad_dec = flags
    assert enc.tolist() == dec.tolist() == [0] * world
    assert bad_enc.sum() == 1 and bad_dec.tolist()[-1] == 1
    assert bad_dec.sum() == 1 and same


def test_run_collective_checks_its_arguments(monkeypatch):
    with pytest.raises(ValueError, match="at least one device"):
        dist.run_collective(cases.run_cases, devices=0,
                            device=torch.device("cpu"))
    with pytest.raises(ValueError, match="at least one rank"):
        dist.spawn_group(cases.run_cases, world=0,
                         device=torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.run_collective(cases.run_cases, devices=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="more than the 1 CUDA devices"):
        dist.run_collective(cases.run_cases, devices=2)
