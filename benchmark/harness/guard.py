"""The modules no run may load: JAX and the JAX side of the repository.
A loaded module's top-level name (before the first dot) is compared
whole, since the port's own name begins with the JAX package's."""

from __future__ import annotations

import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "lucille_tpu", "tools_tpu",
                    "examples_tpu", "bench_large"})


def banned_loaded(modules=None) -> list:
    """The banned top-level names among the loaded modules, sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & BANNED)
