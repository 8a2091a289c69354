"""One-call library API over the codec registry:

    import fl_rl_compression_mpi_tpu_torch as flrl
    comp = flrl.compress(data, method="fl")        # container struct
    out = flrl.decompress(comp, method="fl")
    flrl.compress_file("in.bin", "out.rl", method="rl")   # container on disk
    flrl.decompress_file("out.rl", "restored.bin", method="rl")
    comp = flrl.compress(data, method="fl-dist", devices=2)  # 2 cards

Containers are byte-identical to the JAX package's and to the reference
binary's (pinned by ``tests/golden/reference/`` and ``tests/golden/``).
"""

from __future__ import annotations

import numpy as np

from . import container
from .fileio import load_file, save_file
from .models.registry import ALIASES, CODECS, resolve


def methods() -> dict[str, str]:
    """Available method names (the reference aliases included) →
    description."""
    out = {name: c.description for name, c in CODECS.items()}
    out.update({a: f"alias of {t}" for a, t in ALIASES.items()})
    return out


def _as_u8(data) -> np.ndarray:
    # np.asarray(b"...", np.uint8) treats bytes as a scalar and raises;
    # frombuffer is the zero-copy view for bytes-like inputs
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, np.uint8)
    return np.asarray(data, np.uint8)


def load_container(family: str, path: str):
    """The container file at ``path`` of a codec family (``fl``/``rl``)."""
    return (container.load_rl if family == "rl" else container.load_fl)(path)


def save_container(family: str, path: str, comp) -> None:
    (container.save_rl if family == "rl" else container.save_fl)(path, comp)


def compress(data, method: str = "fl", **opts):
    """Bytes → ``FLCompressed`` / ``RLCompressed``.  ``opts`` pass through
    to the codec: ``frame_length`` for FL; ``device`` for the device
    methods; ``devices`` for ``fl-dist``, ``fl-ici`` and ``rl-dist``, the
    shards of a mesh that this process drives, one a card, or with
    ``device`` all on that device (see ``parallel.dist.run_collective``)."""
    return resolve(method).compress(_as_u8(data), **opts)


def decompress(comp, method: str = "fl", **opts) -> np.ndarray:
    """Container struct → decoded bytes (u8 array)."""
    return resolve(method).decompress(comp, **opts)


def compress_file(input_path: str, output_path: str,
                  method: str = "fl", **opts) -> None:
    """File → container file."""
    codec = resolve(method)
    save_container(codec.family, output_path,
                   codec.compress(load_file(input_path), **opts))


def decompress_file(input_path: str, output_path: str,
                    method: str = "fl", **opts) -> None:
    """Container file → file."""
    codec = resolve(method)
    comp = load_container(codec.family, input_path)
    save_file(output_path, codec.decompress(comp, **opts))
