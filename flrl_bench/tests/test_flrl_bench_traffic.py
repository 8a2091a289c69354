"""The general generator: the same seed gives the same pool, another seed
another, and each part is what its parameters say."""

import os

import pytest
import torch

from conftest import ROOT
from flrl_bench import traffic

MIX = os.path.join(ROOT, "flrl_bench", "traffic")
SEEDS = [0, 7, 2**31 + 11, 2**40 + 3, 2**63 + 5]


def _pool(name, seed, total=1 << 20):
    mix = traffic.load(os.path.join(MIX, name + ".json"))
    return traffic.make_pool(mix, total, 128, seed, "cpu")


@pytest.mark.parametrize("name", ["mixed", "rlmixed", "mixed-resident"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_pool(name, seed):
    a, b = _pool(name, seed), _pool(name, seed)
    assert len(a) == 2 and all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])


@pytest.mark.parametrize("name", ["mixed", "rlmixed"])
def test_other_seed_other_pool(name):
    a, b = _pool(name, 12345), _pool(name, 12346)
    assert not torch.equal(a[0], b[0])


def test_mixed_parts():
    mix = traffic.load(os.path.join(MIX, "mixed.json"))
    total = 4 << 20
    x = traffic.make_pool(mix, total, 128, 99, "cpu")[0]
    sizes = mix.part_bytes(total)
    assert sizes == [768 << 10, 2 << 20, 512 << 10, 768 << 10]
    frames = x.view(-1, 128)
    top = frames.amax(1)
    f0, f1, f2 = (sizes[0] // 128, (sizes[0] + sizes[1]) // 128,
                  (total - sizes[3]) // 128)
    assert bool((top[:f0] == 15).all())
    assert bool((top[f1:f2] == 0).all())
    assert bool((top[f2:] == 255).all())
    # each frame of the random-widths part starts with its width's mask
    first = frames[f0:f1, 0].to(torch.int64)
    assert bool((first == top[f0:f1].to(torch.int64)).all())
    assert bool(((first & (first + 1)) == 0).all() and (first >= 1).all())

def test_runs_part():
    g = traffic.generator(5, "cpu")
    x = traffic.part(g, {"kind": "runs", "lo": 200, "hi": 900, "vmax": 256},
                     1 << 20, 128)
    change = torch.nonzero(x[1:] != x[:-1]).reshape(-1)
    lengths = torch.diff(change)
    assert x.numel() == 1 << 20
    assert int(lengths.min()) >= 200 and int(lengths.max()) <= 900


def test_scaled_parts_cover_the_file():
    mix = traffic.load(os.path.join(MIX, "mixed.json"))
    for total in (1 << 20, 4 << 20, (3124 << 20)):
        assert sum(mix.part_bytes(total)) == total


def test_bad_mix_refused(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text('{"placement": "disk", "pool": 2, "unit_mib": 1, '
                 '"parts": [{"kind": "zeros", "mib": 1}]}')
    with pytest.raises(ValueError):
        traffic.load(str(p))
    p.write_text('{"placement": "host", "pool": 2, "unit_mib": 2, '
                 '"parts": [{"kind": "zeros", "mib": 1}]}')
    with pytest.raises(ValueError):
        traffic.load(str(p))
