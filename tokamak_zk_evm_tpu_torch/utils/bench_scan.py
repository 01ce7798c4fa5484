"""Time B6's scan kernel against the K1 doubling chain it replaced.

    python -m tokamak_zk_evm_tpu_torch.utils.bench_scan [--max-log 24]

For each width 2^10, 2^12, ... up to 2^max-log (random reduced Fr elements
made on the card from a seed) and each direction, checks that the kernel
(`kernels.fr_scan`, one launch) and the chain
(Hillis-Steele doubling over the Fr product kernel K1: log2 B launches, a
clone and two slice copies a level, flips for a suffix; the route before
the kernel, kept here as its yardstick) equal the plain scan (above
PLAIN_MAX_LOG, whose plain scan would take tens of GiB, the kernel equals
the chain), then times both with CUDA events, in turns (chain, kernel,
kernel, chain), and prints one JSON line a width and direction, with the
bytes bound (the array read and written once at 3.35 TB/s), then a last
line with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

PLAIN_MAX_LOG = 22
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def k1_chain(K, a, reverse: bool):
    """Inclusive product scan as log2 B K1 launches (the route before B6)."""
    import torch

    if reverse:
        a = torch.flip(a, [1])
    B, d = a.shape[1], 1
    while d < B:
        nxt = a.clone()
        nxt[:, d:] = K.fr_mul(a[:, d:].contiguous(), a[:, : B - d].contiguous())
        a, d = nxt, 2 * d
    if reverse:
        a = torch.flip(a, [1])
    return a.contiguous()


def main() -> None:
    ap = argparse.ArgumentParser(description="time B6's scan kernel against the K1 chain")
    ap.add_argument("--max-log", type=int, default=24)
    args = ap.parse_args()

    import torch

    from ..backend import kernels as K
    from ..fields import FR

    if not torch.cuda.is_available():
        raise SystemExit("bench_scan needs a CUDA device")
    dev = torch.device("cuda")

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

    for lg in range(10, args.max_log + 1, 2):
        n = 1 << lg
        g = torch.Generator(device=dev).manual_seed(lg)
        a = torch.randint(0, 1 << 16, (16, n), generator=g, device=dev, dtype=torch.int32)
        a[15] = torch.randint(0, FR.modulus >> 240, (n,), generator=g, device=dev,
                              dtype=torch.int32)
        for reverse in (False, True):
            chained = k1_chain(K, a, reverse)
            if lg <= PLAIN_MAX_LOG and not torch.equal(chained, K.plain_fr_scan(a, reverse)):
                raise SystemExit(f"bench_scan: chain != plain at 2^{lg}")
            before = K.FR_SCAN.launches
            ok = torch.equal(K.fr_scan(a, reverse), chained)
            launches = K.FR_SCAN.launches - before
            if not ok:
                ref = "plain" if lg <= PLAIN_MAX_LOG else "chain"
                raise SystemExit(f"bench_scan: kernel != {ref} at 2^{lg}")
            del chained
            reps = 20 if lg <= 18 else 5
            kern = lambda: K.fr_scan(a, reverse)  # noqa: E731
            chain = lambda: k1_chain(K, a, reverse)  # noqa: E731
            c1, k1, k2, c2 = ms(chain, reps), ms(kern, reps), ms(kern, reps), ms(chain, reps)
            print(json.dumps({"n": n, "scan": "suffix" if reverse else "prefix",
                              "kernel_launches": launches, "kernel_ms": [k1, k2],
                              "bytes_bound_ms": 2 * 64 * n / PEAK_BYTES_PER_S * 1e3,
                              "k1_chain_ms": [c1, c2], "k1_chain_launches": lg}), flush=True)
        del a
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip().splitlines()[:1]}))


if __name__ == "__main__":
    main()
