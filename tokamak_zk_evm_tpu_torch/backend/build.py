"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/*.cu` file is compiled on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>.so csrc/<name>.cu

into the package's git-ignored `build/` directory, at first use.  `build_all`
starts one nvcc per source at once.  The ptxas report (registers, spills) of
each build is kept beside the library as `build/<name>.log`.

Several processes may share one checkout (a test run beside `chip_smoke.py`):
a build holds an exclusive `fcntl` lock on `build/.lock`, writes each library
under a temporary name and `os.replace`s it into place, so no process ever
loads a half-written library.

Every C entry takes pointers and the stream as `void*` and returns the
`cudaError_t` of its launches; `call` raises on a non-zero code.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# library -> {C entry: argtypes}; every entry returns an int cudaError_t
SIGNATURES = {
    "field_ew": {"tzk_field_ew": [_I, _I, _P, _P, _P, _LL, _LL, _LL, _P]},
    "field_inv": {
        "tzk_field_inv": [_I, _P, _P, _LL, _P],
        "tzk_batch_inv_up": [_I, _P, _P, _P, _LL, _I, _P],
        "tzk_batch_inv_down": [_I, _P, _P, _P, _LL, _I, _P],
    },
    "fr_scan": {
        "tzk_fr_scan_tile": [],
        "tzk_fr_scan": [_P, _P, _P, _LL, _LL, _I, _P],
    },
    "ntt": {
        "tzk_ntt_passes": [_LL, _LL],
        "tzk_ntt": [_P, _P, _P, _P, _P, _LL, _LL, _LL, _P],
    },
    "g1_affine": {
        "tzk_aff_pre": [_P, _P, _P, _P, _P, _LL, _P],
        "tzk_aff_post": [_P, _P, _P, _P, _P, _P, _P, _LL, _P],
    },
    "g1": {
        "tzk_g1_fixed_base": [_P, _P, _I, _P, _P, _P, _LL, _P],
    },
    "g1_ops": {
        "tzk_g1_add": [_P, _P, _P, _P, _P, _P, _LL, _LL, _P, _P, _P, _LL, _P],
        "tzk_g1_dbl": [_P, _P, _P, _P, _P, _P, _LL, _P],
        "tzk_g1_affine": [_P, _P, _P, _P, _P, _P, _P, _LL, _P],
        "tzk_g1_probe": [_I, _P, _P, _P, _P, _P, _P, _LL, _LL, _P, _P, _P, _LL, _P],
    },
    "msm": {
        "tzk_msm_bucket_sum": [_I, _P, _P, _P, _P, _P, _LL, _P, _P],
        "tzk_msm_window_reduce": [_P, _P, _P, _P, _LL, _I, _I, _P, _P, _P],
    },
    "crs_decode": {"tzk_crs_decode": [_P, _P, _P, _P, _LL, _LL, _LL, _P]},
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return path


def _paths(name: str) -> tuple[str, str, str]:
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"),
            os.path.join(BUILD_DIR, f"{name}.log"))


def _fresh(name: str) -> bool:
    src, so, _ = _paths(name)
    if not os.path.exists(so):
        return False
    newest = max(os.path.getmtime(os.path.join(CSRC, f))
                 for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))
    return os.path.getmtime(so) >= max(newest, os.path.getmtime(src))


def built() -> dict[str, bool]:
    """{library: whether build/ holds it, newer than every source}."""
    return {name: _fresh(name) for name in SIGNATURES}


@contextlib.contextmanager
def build_lock():
    """Hold an exclusive lock on `build/.lock` (across processes)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _tmp(path: str) -> str:
    return f"{path}.{os.getpid()}.tmp"


def _command(name: str) -> list[str]:
    src, so, _ = _paths(name)
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", _tmp(so), src]


def build_all(names=None) -> dict[str, float]:
    """Compile the given libraries (default: all) with one nvcc each, all at
    once.  Returns {name: seconds}; raises with the compiler output on a
    failed build."""
    import time

    names = list(SIGNATURES) if names is None else list(names)
    with build_lock():
        procs = {}
        t0 = time.perf_counter()
        for name in names:
            if _fresh(name):
                continue
            log = open(_paths(name)[2], "w")
            procs[name] = (subprocess.Popen(_command(name), stdout=log,
                                            stderr=subprocess.STDOUT), log)
        took = {}
        failed = []
        for name, (proc, log) in procs.items():
            rc = proc.wait()
            log.close()
            took[name] = time.perf_counter() - t0
            so = _paths(name)[1]
            if rc == 0:
                os.replace(_tmp(so), so)
            else:
                failed.append(name)
    if failed:
        msgs = []
        for name in failed:
            with open(_paths(name)[2]) as f:
                msgs.append(f"--- {name}.cu ---\n{f.read()[-4000:]}")
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return took


def lib(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _LOCK:
        hit = _LIBS.get(name)
        if hit is not None:
            return hit
        build_all([name])
        handle = ctypes.CDLL(_paths(name)[1])
        for entry, argtypes in SIGNATURES[name].items():
            fn = getattr(handle, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = handle
        return handle


def call(name: str, entry: str, *args) -> None:
    """Call one C entry; raise if it reports a CUDA error."""
    err = getattr(lib(name), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry} failed with cudaError_t {err}")
