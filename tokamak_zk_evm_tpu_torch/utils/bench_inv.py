"""Time K2's batch-inversion routes across widths on the card.

    python -m tokamak_zk_evm_tpu_torch.utils.bench_inv [--max-log 22]

For each field and each width 2^8 ... 2^max-log (random reduced elements
made on the card from a seed), times with CUDA events the per-element route
(one extended gcd a thread, `kernels.field_inv`; up to 2^20) and the tiled
route (`kernels.batch_inv` with its per-element width forced to 0) at every
per-thread element count K in 1 ... 32 whose tile fits the batch, checks
that the routes agree, and prints one JSON line a width and a last line
with the card's name.  `kernels.BINV_EACH` and `kernels.binv_per_thread`
are chosen from this table.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json


def main() -> None:
    ap = argparse.ArgumentParser(description="time K2's batch-inversion routes")
    ap.add_argument("--max-log", type=int, default=22)
    args = ap.parse_args()

    import torch

    from ..backend import kernels as K
    from ..fields import FQ, FR

    if not torch.cuda.is_available():
        raise SystemExit("bench_inv needs a CUDA device")
    dev = torch.device("cuda")

    def rand(spec, n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        L = spec.n_limbs
        lim = torch.randint(0, 1 << 16, (L, n), generator=g, device=dev, dtype=torch.int32)
        lim[L - 1] = torch.randint(0, spec.modulus >> (16 * (L - 1)), (n,), generator=g,
                                   device=dev, dtype=torch.int32)
        return lim

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

    each, per_thread = dict(K.BINV_EACH), K.binv_per_thread
    try:
        K.BINV_EACH = {0: 0, 1: 0}
        for field, spec in ((0, FR), (1, FQ)):
            for lg in range(8, args.max_log + 1):
                n = 1 << lg
                a = rand(spec, n, lg)
                reps = 20 if lg < 18 else 5
                want = K.field_inv(field, a)
                row = {"field": spec.name, "n": n}
                if lg <= 20:
                    row["each_ms"] = ms(lambda: K.field_inv(field, a), reps)
                for k in (1, 2, 4, 8, 16, 32):
                    if K.BINV_THREADS * k > n:
                        continue
                    K.binv_per_thread = lambda f, B, k=k: k
                    if not torch.equal(K.batch_inv(field, a), want):
                        raise SystemExit(f"bench_inv: routes disagree at {spec.name} {n}, K={k}")
                    row[f"tiled_K{k}_ms"] = ms(lambda: K.batch_inv(field, a), reps)
                print(json.dumps(row), flush=True)
                del a, want
    finally:
        K.BINV_EACH, K.binv_per_thread = each, per_thread
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
