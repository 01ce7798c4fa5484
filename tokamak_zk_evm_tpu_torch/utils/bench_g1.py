"""Time B13's add and doubling kernels on the card, and split their time.

    python -m tokamak_zk_evm_tpu_torch.utils.bench_g1 [--sass]

At widths 2^10, 2^14, 2^18, 2^22 and 4,147,200 lanes (the ceremony's
widest multiplication: delta_inv_li_o_prv, (m_D - l_D) s_max lanes of the
synthetic full shape), on doubled P+Q pairs (Z != 1, every lane the
generic formula, as `chip_smoke.py` phase 6 builds them), times with CUDA
events

  (a) the add (`kernels.g1_add`) and the doubling (`kernels.g1_dbl`);
  (b) the probe that only loads and stores the same coordinates;
  (c) the probe that runs the same formula on points made from the lane
      index (no loads), storing one word a lane;

beside the bounds (bytes over 3.35 TB/s; 16 and 7 Fq products of 600
operations over the IMAD rate, and the same with the squarings counted as
squarings: 4 of the add's, 5 of the doubling's, 468 operations each).
(a) near (b) + (c) says the loads' waits are not hidden; (a) near
max(b, c) says they are.  The probes live in `csrc/g1_ops.cu`
(`tzk_g1_probe`); on a tree whose source has none, (b) and (c) are left
out.  Checks (a) against the plain versions at the narrowest width first.
Prints one JSON line a width, with --sass the kernels' SASS instructions
by opcode (cuobjdump), and a last line with the card's name and power
limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess

PEAK_BYTES_PER_S = 3.35e12
IMAD_PER_S = 64 * 132 * 1.98e9  # 32-bit IMAD a clock an SM x 132 SMs x boost clock
MUL_OPS = 2 * (2 * 12 * 12 + 12)  # a CIOS product: 300 limb products, two IMAD each
SQR_OPS = 2 * (78 + 12 * 12 + 12)  # a squaring: 78 distinct limb products, then the reduction
CEREMONY_WIDEST = 16200 * 256
WIDTHS = (1 << 10, 1 << 14, 1 << 18, 1 << 22, CEREMONY_WIDEST)
KERNELS = ("g1_add_kernel", "g1_dbl_kernel", "g1_probe_io_add", "g1_probe_io_dbl",
           "g1_probe_math_add", "g1_probe_math_dbl")


def sass_histogram(lib_path: str) -> dict:
    """{kernel: {opcode: count}} from `cuobjdump -sass` of the library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    hist, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = next((k for k in KERNELS if k in m.group(1)), None)
            if fn:
                hist[fn] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and m:
            hist[fn][m.group(1)] += 1
    return {k: dict(v.most_common()) for k, v in hist.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description="time and split B13's add and doubling")
    ap.add_argument("--sass", action="store_true", help="print SASS opcode counts")
    ap.add_argument("--max-log", type=int, default=22, help="widest power of two timed")
    args = ap.parse_args()

    import numpy as np
    import torch

    from ..backend import build
    from ..backend import kernels as K
    from ..host.curve import G1

    if not torch.cuda.is_available():
        raise SystemExit("bench_g1 needs a CUDA device")
    dev = torch.device("cuda")
    lib = build.lib("g1_ops")
    probes = hasattr(lib, "tzk_g1_probe")
    widths = [n for n in WIDTHS if n <= 1 << args.max_log]

    def ptrs(p):
        return [c.data_ptr() for c in p]

    def call(entry, *a):
        err = getattr(lib, entry)(*a, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise SystemExit(f"bench_g1: {entry} failed with cudaError_t {err}")

    def add(P, Q, out):
        call("tzk_g1_add", *ptrs(P), *ptrs(Q), Q[0].shape[1], 1, *ptrs(out), P[0].shape[1])

    def dbl(P, out):
        call("tzk_g1_dbl", *ptrs(P), *ptrs(out), P[0].shape[1])

    def probe(which, P, Q, out):
        call("tzk_g1_probe", which, *ptrs(P), *ptrs(Q), Q[0].shape[1], 1, *ptrs(out),
             out[0].shape[1])

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    # doubled P+Q pairs: P = 2 (a G), Q = 2 (b G), a < b < 2^32
    rng = np.random.default_rng(13)
    n_max = max(widths)
    table = K.fixed_base_table(*G1.gen, dev)

    def points(v):
        cl = np.zeros((16, n_max), np.int32)
        cl[0], cl[1] = v & 0xFFFF, v >> 16
        return K.g1_dbl(K.g1_fixed_base(torch.as_tensor(cl, device=dev), table))

    a = rng.integers(1, 1 << 31, size=n_max, dtype=np.int64)
    P_all = points(a)
    Q_all = points(a + rng.integers(1, 1 << 20, size=n_max, dtype=np.int64))
    del table

    for n in widths:
        P = tuple(c[:, :n].contiguous() for c in P_all)
        Q = tuple(c[:, :n].contiguous() for c in Q_all)
        out = tuple(torch.empty_like(c) for c in P)
        if n == widths[0]:
            add(P, Q, out)
            ok = all(torch.equal(g, w) for g, w in zip(out, K.plain_g1_add(P, Q)))
            dbl(P, out)
            if not (ok and all(torch.equal(g, w) for g, w in zip(out, K.plain_g1_dbl(P)))):
                raise SystemExit(f"bench_g1: kernel != plain at {n} lanes")
        reps = 50 if n <= 1 << 14 else 20 if n <= 1 << 18 else 5
        row = {"n": n,
               "add_ms": ms(lambda: add(P, Q, out), reps),
               "dbl_ms": ms(lambda: dbl(P, out), reps)}
        if probes:
            row["add_io_ms"] = ms(lambda: probe(0, P, Q, out), reps)
            row["dbl_io_ms"] = ms(lambda: probe(1, P, P, out), reps)
            row["add_math_ms"] = ms(lambda: probe(2, P, P, out), reps)
            row["dbl_math_ms"] = ms(lambda: probe(3, P, P, out), reps)
        for op, nbytes, full, sqr in (("add", 9 * 96, 16, 4), ("dbl", 6 * 96, 7, 5)):
            row[f"{op}_bytes_bound_ms"] = nbytes * n / PEAK_BYTES_PER_S * 1e3
            row[f"{op}_imad_bound_ms"] = full * MUL_OPS * n / IMAD_PER_S * 1e3
            row[f"{op}_imad_bound_sqr_ms"] = ((full - sqr) * MUL_OPS + sqr * SQR_OPS) * n \
                / IMAD_PER_S * 1e3
        print(json.dumps(row), flush=True)
        del P, Q, out
    if args.sass:
        for kern, hist in sass_histogram(lib._name).items():
            print(json.dumps({"sass": kern, "total": sum(hist.values()), "ops": hist}),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip().splitlines()[:1]}))


if __name__ == "__main__":
    main()
