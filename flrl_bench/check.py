"""What decides ``correct``.

Every call of the window is held to its file's sizes (the container's
three fields and the decoded length, as the warm-up call gave them, on
host placement) and counted if it raised.  A sample of the window's
answers, drawn from the seed, is copied aside outside the timed calls and
judged after the window against the plain reference: the container byte
for byte against the reference's container of the same file, and the
decoded bytes against the file itself.  Every number has the limit 0: the
codec is lossless and its containers byte-identical to the reference
format, so any byte off is a fault (PERF.md gives the readings).
"""

from __future__ import annotations

import random

import torch

from . import reference, traffic

PER_FILE = 1    # answers of each pool file kept for the reference
LIMITS = {"calls_failed": 0, "sizes_wrong": 0, "samples_short": 0,
          "container_bytes_wrong": 0, "decoded_bytes_wrong": 0}


class Sampler:
    """A uniform sample of each pool file's turns in the window (reservoir
    sampling, one reservoir a file), its draws from the seed: the j-th turn
    of a file replaces a kept one with chance PER_FILE / (j + 1)."""

    def __init__(self, seed: int, pool: int):
        self.rng = random.Random(seed ^ 0x5EED_F1E5)
        self.seen = [0] * pool
        self.kept = {}            # (file, slot) -> (turn, file, answer)

    def offer(self, turn: int, file: int, take) -> None:
        j = self.seen[file]
        self.seen[file] += 1
        slot = j if j < PER_FILE else self.rng.randrange(j + 1)
        if slot >= PER_FILE:
            return
        self.kept.pop((file, slot), None)   # free the old copy first
        self.kept[(file, slot)] = (turn, file, take())

    @property
    def short(self) -> int:
        """Files of the pool with no answer kept."""
        return sum(1 for j in self.seen if j == 0)


def judge(cfg, mix, driver, sampler: Sampler, device, seed: int, *,
          failed: int, sizes_wrong: int) -> dict:
    """{name: (value, limit)} of every number compared."""
    files = {}
    for _, k, _ in sampler.kept.values():
        files.setdefault(k, None)
    if files:
        # the pool once more from the seed, file by file, for the reference
        g = traffic.generator(seed, device)
        for k in range(max(files) + 1):
            x = traffic.make_file(g, mix, cfg.file_bytes, cfg.frame_length)
            if k in files:
                files[k] = (x, reference_container(cfg, x))
            del x
    wrong_c = wrong_d = 0
    for _, k, answer in sampler.kept.values():
        x, want = files[k]
        wrong_c += reference.container_bytes_wrong(
            driver.container(answer, device), want)
        wrong_d += reference.count_differing(driver.decoded(answer, device),
                                             x)
    numbers = {"calls_failed": failed, "sizes_wrong": sizes_wrong,
               "samples_short": sampler.short,
               "container_bytes_wrong": wrong_c,
               "decoded_bytes_wrong": wrong_d}
    return {k: (v, LIMITS[k]) for k, v in numbers.items()}


def reference_container(cfg, x: torch.Tensor) -> reference.Container:
    """The reference's container of file ``x`` for this configuration: one
    container, or where the configuration cuts RL runs at shard boundaries
    (``shards`` > 1) the shards' containers in order, each shard of the
    upstream's split (``file_io.cu:46-51``: every shard but the last
    ``(n // (128 * N)) * 128`` bytes, the last the rest)."""
    if cfg.codec == "fl" or cfg.shards == 1:
        return reference.encode(cfg.codec, x, cfg.frame_length)
    n, N = x.numel(), cfg.shards
    chunk = (n // (128 * N)) * 128
    bounds = [i * chunk for i in range(N)] + [n]
    parts = [reference.encode(cfg.codec, x[a:b], cfg.frame_length)
             for a, b in zip(bounds[:-1], bounds[1:])]
    return reference.Container(n, torch.cat([p.first for p in parts]),
                               torch.cat([p.second for p in parts]))


def correct(numbers: dict) -> bool:
    return all(v <= lim for v, lim in numbers.values())
