"""Build the repository's native host libraries once, before any test runs.

The JAX package compiles `native/libzk_kernels.so` and
`native/libkeccak256.so` with g++ at first use, in place and with no lock.
Under `pytest -n N` on a fresh checkout several workers would run the same
g++ at once and overwrite each other's output, failing their tests with
`CalledProcessError`.  Every xdist worker imports every test module before
it runs any test, so this module, at import time and under an exclusive
`fcntl` lock on `.cache/native_build.lock`, builds those libraries (and the
port's keccak helper): the first worker builds, the others wait and then
find them fresh by their mtime check.
"""

import fcntl
import os
import pathlib

import numpy as np

from tokamak_zk_evm_tpu import fields as JF
from tokamak_zk_evm_tpu.backend import native
from tokamak_zk_evm_tpu.host import keccak as jax_keccak
from tokamak_zk_evm_tpu_torch.host import keccak as port_keccak

_LOCK = pathlib.Path(__file__).resolve().parent.parent / ".cache" / "native_build.lock"
_LOCK.parent.mkdir(parents=True, exist_ok=True)
with open(_LOCK, "a") as _f:
    fcntl.flock(_f, fcntl.LOCK_EX)
    try:
        native._build()
        jax_keccak._load_native()
        port_keccak._load_native()
    finally:
        fcntl.flock(_f, fcntl.LOCK_UN)


def test_native_library_built_and_exact():
    assert os.path.exists(native._SO)
    assert native._register() is True
    rng = np.random.default_rng(5)
    vals = [int.from_bytes(rng.bytes(32), "little") % JF.R_MOD for _ in range(2)]
    a, b = ([JF.FR.to_limbs(JF.FR.to_mont(v))] for v in vals)
    a, b = (np.asarray(x, np.uint32).T for x in (a, b))  # [16, 1] limb-major
    got = np.asarray(native.fr_mul(a, b))
    want = JF.FR.to_mont(vals[0] * vals[1] % JF.R_MOD)
    assert JF.FR.from_limbs(got[:, 0].tolist()) == want
