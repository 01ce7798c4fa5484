"""Per-layer metric readers, one file a metric, found by the metric's name.

`<name>.py` defines `read(rec)`, which returns the metric's value from the
traced run's record, or None where the record holds nothing to read (the
harness then leaves the metric out).  The record: `jobs` (per job: start_s,
crs_load_s, init_s, rounds_s where measured), `proofs`, `window_s`,
`busy_s`, `kernels`, `by_name` (device seconds by kernel name), `msm`
([points, live points] a call), `ntt` ([n, batch] a call), `kind` (the
card's name).
"""

from __future__ import annotations

import importlib.util
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str):
    """The reader module of metric `name`."""
    key = "zkbench.metrics._" + name.replace(".", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(_HERE, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
