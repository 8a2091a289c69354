"""The two ways the benchmark drives the program, chosen by the traffic's
placement.  Each loads the pool, makes one compress or decompress call,
waits for the device where its results stay there, and hands the reference
what a call produced.  This is the only module that imports the program.

* ``HostFiles`` (placement ``host``): a file is a host u8 array, and a call
  is the library API's ``compress`` / ``decompress`` with the
  configuration's method (``fl``, ``rl``, ``fl-ici`` at ``devices=N``...):
  the copies up and down, the dispatch walk and the kernels, its result
  returned in host memory.
* ``Resident`` (placement ``device``): a file is put on the cards once in
  set-up (``dist.shard_host_data`` over ``dist.make_local_mesh``), and a
  call is a device-resident program (FL: ``fl_compress_sharded_dense`` /
  ``fl_decompress_sharded_dense``; RL: ``rl_compress_sharded`` /
  ``rl_decompress_sharded``), then a synchronise of every card.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import Container


def _u8(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint8))


class HostFiles:
    def __init__(self, config, device=None):
        from fl_rl_compression_mpi_tpu_torch import api
        from fl_rl_compression_mpi_tpu_torch.models.registry import resolve
        self.api = api
        self.config = config
        self.method = config.method
        self.opts = {}
        if config.codec == "fl":
            self.opts["frame_length"] = config.frame_length
        if resolve(config.method).distributed:
            self.opts["devices"] = config.cards
        if device is not None:
            self.opts["device"] = device
        self.cards = (tuple(range(config.cards))
                      if device is None else ())
        self.files = []
        self.slots = {}

    def load(self, pool) -> None:
        self.files = [t.cpu().numpy() for t in pool]

    def compress(self, k: int):
        return self.api.compress(self.files[k], method=self.method,
                                 **self.opts)

    def decompress(self, comp):
        return self.api.decompress(comp, method=self.method, **self.opts)

    def sync(self) -> None:
        pass

    @staticmethod
    def _fields(comp):
        first = comp.bits if hasattr(comp, "bits") else comp.counts
        return np.asarray(first), np.asarray(comp.values)

    def sizes(self, comp, out) -> tuple:
        """What every call's answer must repeat for its file."""
        first, second = self._fields(comp)
        return int(comp.input_size), first.size, second.size, out.size

    def container_bytes(self, comp) -> int:
        first, second = self._fields(comp)
        return 24 + first.size + second.size

    def keep(self, comp, out, k: int):
        """A copy of a call's answer, made outside the timed calls into file
        ``k``'s slot: host memory that set-up's copy of the warm-up answer
        has already touched, so that the window allocates nothing."""
        parts = (*self._fields(comp), np.asarray(out))
        slot = self.slots.get(k)
        if slot is None or [a.shape for a in slot] != [a.shape for a in parts]:
            slot = self.slots[k] = [np.empty_like(a) for a in parts]
        for dst, src in zip(slot, parts):
            np.copyto(dst, src)
        return (int(comp.input_size), *slot)

    def container(self, kept, device) -> Container:
        n, first, second, _ = kept
        return Container(n, _u8(first).to(device), _u8(second).to(device))

    def decoded(self, kept, device) -> torch.Tensor:
        return _u8(kept[3]).to(device)

    def close(self) -> None:
        self.files = []


class Resident:
    def __init__(self, config, device=None):
        from fl_rl_compression_mpi_tpu_torch.parallel import dist
        self.dist = dist
        self.config = config
        self.mesh = (dist.make_local_mesh(config.cards) if device is None
                     else dist.make_mesh(config.cards, device))
        self.cards = tuple(d.index for d in self.mesh if d.type == "cuda")
        self.plan = dist.plan_shards(config.file_bytes, config.cards,
                                     config.frame_length)
        self.L = config.frame_length
        self.shards = []
        self.slots = {}

    def load(self, pool) -> None:
        self.shards = [self.dist.shard_host_data(t.cpu().numpy(), self.plan,
                                                 self.mesh) for t in pool]

    def compress(self, k: int):
        if self.config.codec == "fl":
            return self.dist.fl_compress_sharded_dense(
                self.shards[k], self.plan.ns, self.L, mesh=self.mesh)
        return self.dist.rl_compress_sharded(self.shards[k], self.plan.ns,
                                             mesh=self.mesh)

    def decompress(self, comp):
        first, second, _ = comp
        if self.config.codec == "fl":
            return self.dist.fl_decompress_sharded_dense(
                second, first, self.plan.ns, self.L, mesh=self.mesh)
        return self.dist.rl_decompress_sharded(first, second, self.plan.ns,
                                               mesh=self.mesh)

    def sync(self) -> None:
        for dev in self.mesh:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _parts(self, comp):
        """Per shard: the container's first field and second field."""
        first, second, totals = comp
        out = []
        for i, (f, s, t) in enumerate(zip(first, second, totals)):
            used = int(t.reshape(-1)[0])
            if self.config.codec == "fl":
                frames = -(-int(self.plan.ns[i]) // self.L)
                out.append((f[:frames], s[:used]))
            else:
                out.append((f[:used], s[:used]))
        return out

    def sizes(self, comp, out) -> tuple:
        return ()   # read back only in set-up and for the sample

    def container_bytes(self, comp) -> int:
        return 24 + sum(f.numel() + s.numel() for f, s in self._parts(comp))

    def keep(self, comp, out, k: int):
        """Copies on the cards of a call's answer into file ``k``'s slot,
        allocated by set-up's copy of the warm-up answer (the outputs' own
        buffers return to the allocator at the next call)."""
        parts = [t for group in (*comp, out) for t in group]
        slot = self.slots.get(k)
        if slot is None or [t.shape for t in slot] != [t.shape for t in parts]:
            slot = self.slots[k] = [torch.empty_like(t) for t in parts]
        for dst, src in zip(slot, parts):
            dst.copy_(src)
        n = len(comp[0])
        return tuple(slot[i * n:(i + 1) * n] for i in range(4))

    def container(self, kept, device) -> Container:
        parts = self._parts(kept[:3])
        return Container(self.config.file_bytes,
                         torch.cat([f.to(device) for f, _ in parts]),
                         torch.cat([s.to(device) for _, s in parts]))

    def decoded(self, kept, device) -> torch.Tensor:
        return torch.cat([o.to(device) for o in kept[3]])

    def close(self) -> None:
        self.shards = []
        self.slots = {}


def make(config, traffic, device=None):
    if traffic.placement == "host":
        return HostFiles(config, device)
    return Resident(config, device)
