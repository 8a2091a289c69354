"""The JAX experiment scripts' definitions, loaded without running them,
for the tests that hold the port's experiment entry points against them.

Importing ``experiments/exp21_tile_packed.py``, ``exp30_rl_starts.py`` or
``exp38_step_overhead.py`` runs its ``main()`` (a ``try: main()`` at module
level), and ``exp6_r2_tuning.py`` runs its whole body at import, staging
256 MiB.  So each script's source is executed only up to that block (or up
to ``if __name__`` for exp22 and exp33) with ``__file__`` set, and exp6's
``copy_kernel`` and ``copy_pallas`` are taken from its syntax tree alone.
``JAX_COMPILATION_CACHE_DIR`` is empty meanwhile, so that the scripts'
``_enable_compile_cache()`` leaves JAX's configuration alone, and
``sys.path`` is restored after each (the scripts prepend to it).  Nothing
of the JAX package or of the scripts changes.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import os
import re
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = os.path.join(REPO, "experiments")
_STOP = re.compile(r"^(try:\n    main\(\)|if __name__ == \"__main__\":)",
                   re.M)


def _path(name: str) -> str:
    return os.path.join(EXPERIMENTS, name + ".py")


@contextlib.contextmanager
def _isolated():
    saved_path = list(sys.path)
    saved_cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    os.environ["JAX_COMPILATION_CACHE_DIR"] = ""
    try:
        yield
    finally:
        sys.path[:] = saved_path
        if saved_cache is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = saved_cache


@functools.lru_cache(maxsize=None)
def load(name: str) -> types.SimpleNamespace:
    """The definitions of ``experiments/<name>.py``, up to its main."""
    path = _path(name)
    with open(path) as f:
        src = f.read()
    stop = _STOP.search(src)
    if stop is None:
        raise AssertionError(f"{name}: no main block found")
    ns = {"__name__": f"jax_{name}", "__file__": path}
    with _isolated():
        exec(compile(src[:stop.start()], path, "exec"), ns)
    return types.SimpleNamespace(**ns)


@functools.lru_cache(maxsize=None)
def load_exp6_copy() -> types.SimpleNamespace:
    """``copy_kernel`` and ``copy_pallas`` of ``exp6_r2_tuning.py``."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    path = _path("exp6_r2_tuning")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    keep = [node for node in tree.body
            if isinstance(node, ast.FunctionDef)
            and node.name in ("copy_kernel", "copy_pallas")]
    assert len(keep) == 2, [node.name for node in keep]
    ns = {"functools": functools, "jax": jax, "jnp": jnp, "pl": pl,
          "pltpu": pltpu, "LANES": 128}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return types.SimpleNamespace(**ns)
