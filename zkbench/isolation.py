"""The modules that no process of a run may hold: JAX and the JAX package.

Compared by whole top-level name (the part before the first dot), since the
port's name, `tokamak_zk_evm_tpu_torch`, begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "tokamak_zk_evm_tpu")


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name is one the port must not load."""
    names = sys.modules if names is None else names
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})
