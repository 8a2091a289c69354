"""The PyTorch package and chip_smoke.py never import JAX, nor anything of
the JAX package: the machine with the GPU has no JAX, and the port keeps its
own copies of the JAX package's framework-free modules."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROGRAM = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now raises
import importlib, pkgutil
import numpy as np
import fl_rl_compression_mpi_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
# the walk reached the experiment entry points; none ran its main (which
# prints its device first: this program's output is "ok" alone)
for name in ("exp21_tile_packed", "exp22_tile_packed2", "exp30_rl_starts",
             "exp33_round_latency", "exp6_r2_tuning"):
    assert pkg.__name__ + ".experiments." + name in sys.modules, name
import chip_smoke
import chip_routes
import chip_dist
from fl_rl_compression_mpi_tpu_torch.ops import fl_torch, rl_torch
data = np.random.default_rng(0).integers(0, 32, 50_000, np.uint8)
bits, values = fl_torch.encode(data, device="cpu")
assert np.array_equal(fl_torch.decode(data.size, bits, values,
                                      device="cpu"), data)
data = np.repeat(data % 4, 9)
counts, values = rl_torch.encode(data, device="cpu")
assert np.array_equal(rl_torch.decode(counts, values, device="cpu"), data)
# the distributed path: one shard, then two, in this process
import torch
import fl_rl_compression_mpi_tpu_torch as flrl
from fl_rl_compression_mpi_tpu_torch.parallel import dist
for method in ("fl-dist", "fl-ici", "rl-dist"):
    comp = flrl.compress(data, method=method, device="cpu")
    assert np.array_equal(flrl.decompress(comp, method=method,
                                          device="cpu"), data)
    comp = flrl.compress(data, method=method, device="cpu", devices=2)
    assert np.array_equal(flrl.decompress(comp, method=method,
                                          device="cpu", devices=2), data)
zeros = torch.zeros(128 * 40, dtype=torch.uint8)
def constant(*, mesh):
    shards = [zeros[:128 * 20], zeros[128 * 20:]][:len(mesh)]
    bits, values, flags = dist.fl_compress_sharded_dense_constant(
        shards, 0, 1, mesh=mesh)
    out, dflags = dist.fl_decompress_sharded_dense_constant(
        values, [v.numel() for v in values], [x.numel() for x in shards],
        0, 1, mesh=mesh)
    return (int(flags.sum() + dflags.sum()),
            all(bool((o == 0).all()) for o in out))
for k in (1, 2):
    assert dist.run_collective(constant, devices=k,
                               device=torch.device("cpu")) == (0, True)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib")
                and sys.modules[m] is not None)
assert not loaded, loaded
# nor anything of the JAX package, which would bring its side effects
# (fl_rl_compression_mpi_tpu/__init__.py's allocator settings) with it
jax_pkg = sorted(m for m in sys.modules
                 if m == "fl_rl_compression_mpi_tpu"
                 or m.startswith("fl_rl_compression_mpi_tpu."))
assert not jax_pkg, jax_pkg
print("ok")
"""


_FIELD_ROUTE = r"""
import os, sys
sys.modules["jax"] = None
import numpy as np
from fl_rl_compression_mpi_tpu_torch.ops import fl_torch
os.environ["FLRL_NO_DENSE"] = "1"
g = np.random.default_rng(1)
hit = g.integers(0, 16, 300_000, np.uint8)       # every width <= 4
miss = g.integers(0, 64, 300_000, np.uint8)
for data, L in ((hit, 128), (miss, 128), (hit, 24)):
    bits, values = fl_torch.encode(data, L, device="cpu")
    assert np.array_equal(fl_torch.decode(data.size, bits, values, L,
                                          device="cpu"), data)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib")
                and sys.modules[m] is not None)
assert not loaded, loaded
jax_pkg = sorted(m for m in sys.modules
                 if m == "fl_rl_compression_mpi_tpu"
                 or m.startswith("fl_rl_compression_mpi_tpu."))
assert not jax_pkg, jax_pkg
print("ok")
"""


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def test_port_never_imports_jax():
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_field_route_never_imports_jax():
    proc = subprocess.run([sys.executable, "-c", _FIELD_ROUTE], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_gpu():
    """Without CUDA the smoke exits nonzero and prints no result."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch\n"
         "torch.cuda.is_available = lambda: False\n"
         "sys.argv = ['chip_smoke.py']\n"
         "import chip_smoke\n"
         "sys.exit(chip_smoke.main())\n"],
        cwd=REPO, env=_clean_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Alone in a directory, the smoke cannot import the package."""
    script = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        script.write_text(f.read())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
