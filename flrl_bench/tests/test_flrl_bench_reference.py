"""The frozen reference reproduces the containers in tests/golden (written
by the reference binary and by the repository's codecs), and its control
breaks the guarantee it should."""

import glob
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from flrl_bench import control, reference, spec

GOLD = os.path.join(ROOT, "tests", "golden")
CASES = sorted(glob.glob(os.path.join(GOLD, "reference", "case_*.bin")))


def _bytes(path):
    return torch.from_numpy(np.fromfile(path, np.uint8))


@pytest.mark.parametrize("path", CASES,
                         ids=[os.path.basename(p)[:-4] for p in CASES])
def test_fl_matches_reference_binary(path):
    with open(path[:-4] + ".fl", "rb") as f:
        want = f.read()
    assert reference.to_bytes(reference.fl_encode(_bytes(path), 128)) == want


@pytest.mark.parametrize("family", ["fl", "rl"])
def test_golden_input(family):
    with open(os.path.join(GOLD, "input." + family), "rb") as f:
        want = f.read()
    got = reference.encode(family, _bytes(os.path.join(GOLD, "input.bin")),
                           128)
    assert reference.to_bytes(got) == want


@pytest.mark.parametrize("L", [8, 24, 128, 1024])
def test_fl_partial_last_frame(L):
    g = torch.Generator().manual_seed(L)
    x = torch.randint(0, 64, (5 * L + 3,), dtype=torch.uint8, generator=g)
    c = reference.fl_encode(x, L)
    assert c.first.numel() == 6
    assert int(c.first.max()) <= 6
    bits = int((c.first[:-1].to(torch.int64) * L).sum() + 3 * int(c.first[-1]))
    assert c.second.numel() == -(-bits // 8)


def test_rl_runs_cut_at_255():
    x = torch.cat([torch.full((600,), 7, dtype=torch.uint8),
                   torch.full((255,), 1, dtype=torch.uint8),
                   torch.tensor([1, 2], dtype=torch.uint8)])
    c = reference.rl_encode(x)
    assert c.first.tolist() == [255, 255, 90, 255, 1, 1]
    assert c.second.tolist() == [7, 7, 7, 1, 1, 2]


def test_empty_streams():
    empty = torch.zeros(0, dtype=torch.uint8)
    for family in ("fl", "rl"):
        c = reference.encode(family, empty, 128)
        assert reference.to_bytes(c) == bytes(24)


@pytest.mark.parametrize("family", ["fl", "rl"])
def test_control_breaks_the_guarantee(family):
    x = _bytes(os.path.join(GOLD, "input.bin"))
    want = reference.encode(family, x, 128)
    cfg = spec.Config("c", family, family, 128, 1, 1, 1)
    container, decoded = control.answer(cfg, x)
    assert reference.container_bytes_wrong(container, want) > 0
    assert reference.count_differing(decoded, x) > 0


def test_counting():
    a = torch.tensor([1, 2, 3], dtype=torch.uint8)
    assert reference.count_differing(a, a) == 0
    assert reference.count_differing(a, a[:2]) == 1
    assert reference.count_differing(a, torch.tensor([1, 9, 3, 4],
                                                     dtype=torch.uint8)) == 2
    c = reference.Container(3, a, a)
    assert reference.container_bytes_wrong(c, c) == 0
    assert reference.container_bytes_wrong(
        reference.Container(4, a, a), c) == 1
