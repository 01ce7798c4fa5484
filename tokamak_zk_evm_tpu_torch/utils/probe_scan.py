"""Split B6's scan kernel (`backend/csrc/fr_scan.cu`) into its parts on the card.

    python -m tokamak_zk_evm_tpu_torch.utils.probe_scan [--logs 20 22]

Builds copies of the kernel's source, each with one part cut out by a
textual edit, and times each at 2^log elements (random Fr limbs made on the
card from a seed, prefix scan) with CUDA events, in turns, the scratch
zeroed before every launch as the wrapper does.  Only "kernel" computes the
scan; the others are for timing:

  kernel          the source as it is;
  narrow_mul      fr_chain.cuh's `mul` in place of `mul_wide`;
  no_look_back    every tile's prefix taken as one: no wait, no product;
  no_memory       loads made from the element index, no stores;
  no_products     every product an XOR of the words;
  memory_only     no_products and no_look_back;
  products_only   no_memory and no_look_back.

Then the kernel with a timestamp (%globaltimer) at each phase of each tile
(taken, staged, scanned within the tile, prefix known, positions
multiplied, stored) prints, a width each, every phase's mean and spread
over the tiles, its share of the blocks' time, and how many tiles are in
each phase at 16 moments of the launch.  The last line holds the card's name
and power limit.  Needs a CUDA device and nvcc; builds under the package's
git-ignored `build/probe_scan/`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess

from ..backend import build

_FAKE = """
namespace fake {
__device__ __forceinline__ void mul(uint32_t (&r)[8], const uint32_t (&a)[8],
                                    const uint32_t (&b)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = a[k] ^ b[k];
}
}  // namespace fake
"""

_SYNTH = """__device__ __forceinline__ void gload(fe& x, const int32_t* __restrict__ p, long long i,
                                      long long stride) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) x[k] = (uint32_t)(i * 2654435761ll) + k * 77u;
  x[7] &= 0x3fffffffu;
}

__device__ __forceinline__ void gstore(int32_t* __restrict__ p, long long i, long long stride,
                                       const fe& x) {
  if (x[0] == 0xdeadbeefu && x[1] == 7u) p[i] = (int32_t)x[2];
}

"""

_CLOCK = """__device__ __forceinline__ unsigned long long now() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(v));
  return v;
}

"""

PHASES = ("stage", "scan", "prefix", "multiply", "store")


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"probe_scan: the kernel's source no longer holds {old!r}")
    return src.replace(old, new)


def _no_look_back(s):
    s = _sub(s, "group_exclusive(e, tflag, tagg, g * GROUP, q);", "set_one(e);")
    return _sub(s, "look_back(x, gflag, gagg, gincl, g);", "set_one(x);")


def _no_products(s):
    s = _sub(s, '#include "fr_chain.cuh"', '#include "fr_chain.cuh"\n' + _FAKE)
    return _sub(s, "frc::mul_wide(", "fake::mul(")


def _no_memory(s):
    a, b = s.index("__device__ __forceinline__ void gload("), s.index("// the element at")
    return s[:a] + _SYNTH + s[b:]


def _trace(s):
    """Timestamps ts[8 j + phase] by thread 0; the C entry takes ts last."""
    s = _sub(s, "// the element at", _CLOCK + "// the element at")
    s = _sub(s, "long long B, int rev) {", "long long B, int rev, unsigned long long* ts) {")
    mark = "  if (threadIdx.x == 0) ts[j * 8 + {}] = now();\n"
    for phase, anchor in enumerate(("  // this thread's positions, scanned",
                                    "  if (w == 0) {\n    // the warp totals'",
                                    "  // every position times this thread's"), 1):
        s = _sub(s, anchor, mark.format(phase) + anchor)
    s = _sub(s, "  const long long j = tile;\n", "  const long long j = tile;\n" + mark.format(0))
    tail = s.index("}\n\n}  // namespace")
    body = s[:tail]
    last = body.rindex("  __syncthreads();\n")
    s = (body[:last] + mark.format(4) + body[last:] + "  __syncthreads();\n" + mark.format(5)
         + s[tail:])
    s = _sub(s, "int rev, void* stream) {", "int rev, void* stream, void* ts) {")
    return _sub(s, "(uint32_t*)status, B, rev);",
                "(uint32_t*)status, B, rev, (unsigned long long*)ts);")


VARIANTS = {
    "kernel": lambda s: s,
    "narrow_mul": lambda s: _sub(s, "frc::mul_wide(", "frc::mul("),
    "no_look_back": _no_look_back,
    "no_memory": _no_memory,
    "no_products": _no_products,
    "memory_only": lambda s: _no_products(_no_look_back(s)),
    "products_only": lambda s: _no_memory(_no_look_back(s)),
    "trace": _trace,
}


def _build(out_dir: str) -> dict[str, str]:
    """Each variant's library, built with one nvcc each, all at once."""
    os.makedirs(out_dir, exist_ok=True)
    for h in ("fq_chain.cuh", "fr_chain.cuh"):
        shutil.copy(os.path.join(build.CSRC, h), out_dir)
    with open(os.path.join(build.CSRC, "fr_scan.cu")) as f:
        src = f.read()
    procs, libs = [], {}
    for name, edit in VARIANTS.items():
        cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"lib{name}.so")
        with open(cu, "w") as f:
            f.write(edit(src))
        cmd = [build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-o", so, cu]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
        libs[name] = so
    for name, p in procs:
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"probe_scan: nvcc failed on {name}:\n{out[-3000:]}")
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description="split B6's scan kernel into its parts")
    ap.add_argument("--logs", type=int, nargs="+", default=[20, 22])
    args = ap.parse_args()

    import numpy as np
    import torch

    from ..backend import kernels as K
    from ..fields import FR

    if not torch.cuda.is_available():
        raise SystemExit("probe_scan needs a CUDA device")
    dev = torch.device("cuda")
    libs = _build(os.path.join(build.BUILD_DIR, "probe_scan"))
    P = ctypes.c_void_p
    fns = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(so).tzk_fr_scan
        fn.restype = ctypes.c_int
        fn.argtypes = [P, P, P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, P] + (
            [P] if name == "trace" else [])
        fns[name] = fn
    stream = torch.cuda.current_stream().cuda_stream

    for lg in args.logs:
        n = 1 << lg
        g = torch.Generator(device=dev).manual_seed(lg)
        a = torch.randint(0, 1 << 16, (16, n), generator=g, device=dev, dtype=torch.int32)
        a[15] = torch.randint(0, FR.modulus >> 240, (n,), generator=g, device=dev,
                              dtype=torch.int32)
        out = torch.empty_like(a)
        words = K.scan_status_words(n)
        status = torch.zeros(words, dtype=torch.int32, device=dev)
        nt = -(-n // K.SCAN_TILE)
        ts = torch.zeros(8 * nt, dtype=torch.int64, device=dev)

        def launch(name):
            status.zero_()
            extra = (ts.data_ptr(),) if name == "trace" else ()
            if fns[name](a.data_ptr(), out.data_ptr(), status.data_ptr(), words, n, 0, stream,
                         *extra):
                raise SystemExit(f"probe_scan: {name} failed to launch")

        launch("kernel")
        if not torch.equal(out, K.plain_fr_scan(a)):
            raise SystemExit(f"probe_scan: the kernel != plain at 2^{lg}")

        def ms(name, reps=20):
            launch(name)
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(reps):
                launch(name)
            e.record()
            torch.cuda.synchronize()
            return s.elapsed_time(e) / reps

        names = [v for v in VARIANTS if v != "trace"]
        times = {v: [] for v in names}
        for order in (names, names[::-1]):
            for v in order:
                times[v].append(round(ms(v), 4))
        print(json.dumps({"n": n, "ms": times}), flush=True)

        launch("trace")
        torch.cuda.synchronize()
        T = ts.cpu().numpy().reshape(nt, 8)[:, :6].astype(np.int64)
        T -= T[:, 0].min()
        dur = np.diff(T, axis=1) / 1e3
        share = dur.sum(axis=0) / dur.sum()
        moments = np.linspace(0, T[:, 5].max(), 16)
        timeline = [[round(float(t) / 1e3, 1)]
                    + [int(((T[:, i] <= t) & (t < T[:, i + 1])).sum()) for i in range(5)]
                    for t in moments]
        print(json.dumps({
            "n": n, "tiles": nt, "launch_us": round(float(T[:, 5].max()) / 1e3, 1),
            "phase_us": {p: {"mean": round(float(d.mean()), 2),
                             "p10": round(float(np.percentile(d, 10)), 2),
                             "p90": round(float(np.percentile(d, 90)), 2)}
                         for p, d in zip(PHASES, dur.T)},
            "phase_share": {p: round(float(x), 3) for p, x in zip(PHASES, share)},
            "tiles_in_phase": {"phases": list(PHASES), "at_us": timeline}}), flush=True)
        del a, out, status, ts
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip().splitlines()[:1]}))


if __name__ == "__main__":
    main()
