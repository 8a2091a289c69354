"""The control of ``correct``: the plain reference put in the program's
place one step below the configuration's guarantee, judged by the same
comparison as a run.  It must come out not correct.

    python -m flrl_bench.control --workload <name> --seeds <n> [<n> ...]

A codec states no precision; its guarantee is that it is lossless, with
containers byte-identical to the reference format.  The control breaks it
as a lossy codec would: it keeps seven bits of each byte (the lowest bit
dropped), encodes that with the reference, and decodes it exactly.  For
every seed it makes the cell's pool at the cell's own size on the card,
hands each file's control answer to ``check.judge`` as a run hands its
sampled answers, and prints every number beside its limit.  The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, spec, traffic


class _Answers:
    """Stands in for a run's ``drivers`` object at check time: an answer is
    already a (container, decoded bytes) pair of tensors."""

    @staticmethod
    def container(answer, device):
        return answer[0]

    @staticmethod
    def decoded(answer, device):
        return answer[1]


def answer(cfg, x: torch.Tensor):
    """The control's answer for file ``x``: seven bits a byte, encoded by
    the reference as this configuration's container, decoded exactly."""
    seven = x & 0xFE
    return check.reference_container(cfg, seven), seven


def readings(cell: spec.Cell, seed: int, device) -> dict:
    """{name: (value, limit)} of the control on the cell's pool."""
    cfg, mix = cell.config, cell.traffic
    sampler = check.Sampler(seed, mix.pool)
    g = traffic.generator(seed, device)
    for k in range(mix.pool):
        x = traffic.make_file(g, mix, cfg.file_bytes, cfg.frame_length)
        pair = answer(cfg, x)
        sampler.offer(k, k, lambda: pair)
        del x
    return check.judge(cfg, mix, _Answers(), sampler, device, seed,
                       failed=0, sizes_wrong=0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m flrl_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("[flrl_bench.control] no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        numbers = readings(cell, seed, device)
        print(json.dumps({"workload": cell.workload, "seed": seed,
                          "correct": check.correct(numbers),
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in numbers.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
