"""Subcircuit-library resolution — the reference's embedded-library
equivalent (`libs/src/subcircuit_library.rs:12-57`); the port's copy of the
JAX package's module, with the port's own package data dir.

The reference's release binaries embed the compiled qap-compiler library and
materialize it to a temp dir at runtime; dev builds require
`--subcircuit-library PATH`.  The TPU framework's equivalent chain:

  1. an explicit --library PATH (CLI flag), like the reference dev build;
  2. the TZK_SUBCIRCUIT_LIBRARY environment variable;
  3. a library embedded in the installed package at
     `tokamak_zk_evm_tpu_torch/data/subcircuit_library/` (a copy of a
     qap-compiler library dir, placed there by a release build).

No temp-dir materialization is needed: Python package data is already a
directory on disk.
"""

from __future__ import annotations

import os

_PKG_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "subcircuit_library",
)


def embedded_library_path() -> str | None:
    """The packaged library dir, if this build embeds one."""
    if os.path.isfile(os.path.join(_PKG_DATA, "setupParams.json")):
        return _PKG_DATA
    return None


def resolve_library_path(local_path: str | None = None) -> str:
    """Resolve the subcircuit library directory (reference
    `resolve_subcircuit_library_path`)."""
    if local_path:
        p = os.path.realpath(local_path)
        if not os.path.isfile(os.path.join(p, "setupParams.json")):
            raise FileNotFoundError(
                f"{local_path} is not a subcircuit library dir "
                "(no setupParams.json)"
            )
        return p
    env = os.environ.get("TZK_SUBCIRCUIT_LIBRARY")
    if env:
        return resolve_library_path(env)
    emb = embedded_library_path()
    if emb:
        return emb
    raise SystemExit(
        "--library is required (this build has no embedded subcircuit "
        "library; copy a library dir to tokamak_zk_evm_tpu_torch/data/"
        "subcircuit_library to embed one)"
    )
