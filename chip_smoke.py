#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with one NVIDIA GPU and no arguments:

    python3 chip_smoke.py

Phases, in order (any mismatch or exception exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of the port from `tokamak_zk_evm_tpu_torch/backend/csrc`
     (one nvcc per source, all at once);
  3. each kernel against its plain PyTorch version on the card, exact:
     K1/K2 on Fr and Fq batches holding 0, 1 and p-1; K3 forward and inverse
     at 16384 x 512 (and a coset round trip); K4 fixed-base and MSM at 2^12
     with repeated points, infinities and zero scalars; the MSM at 2^22
     against the O(1) oracle sum k_i (c_i G) = (sum k_i c_i) G;
  4. the toy proof on the card: its digest must be the pinned one and the
     port's verifier must accept it;
  5. the main path at the synthetic full shape (n=4096, s_max=256,
     m_i=4096): generate_sigma -> Prover.prove() -> verify_snark(), with every
     kernel's launch counter set to 0 just before and read just after;
  6. each kernel at the main path's shapes: held against its plain version
     there (every output of K1, K2, K3, the fixed-base kernel and the window
     reduce; every 64th chunk of the 2^22-point bucket sum, all of it at
     2^16), then timed beside the plain version and its bound.
The last three lines are the nvidia-smi line, the kernels JSON and the device
JSON. The port imports nothing of JAX; neither does this script.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the
# float32 rate outside the tensor cores. Operations are counted as two per
# 32 x 32 -> 64-bit limb product (a multiply-add counted as two operations,
# as an FMA is), so `bound_ms` is a floor taken at the float32 rate. The
# integer units are slower: 32-bit IMAD issues at 64 per clock per SM, half
# the float32 rate, and one limb product takes two (lo and hi), so the same
# count over IMAD_PER_S (132 SMs at the 1.98 GHz boost clock) is the bound of
# the integer multipliers themselves, `imad_bound_ms`.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
IMAD_PER_S = 64 * 132 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def expect(cond: bool, what: str) -> None:
    if not cond:
        fail(what)
    log(f"  ok  {what}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps: int = 5, warm: bool = True) -> float:
    if warm:
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def rand_field(np, rng, spec, n: int):
    """[L, n] int32 reduced limbs; columns 0..4 hold 0, 1, p-1, R, -R."""
    L = spec.n_limbs
    lim = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    lim[L - 1] = rng.integers(0, spec.modulus >> (16 * (L - 1)), size=n)
    p = spec.modulus
    for k, v in enumerate((0, 1, p - 1, spec.R_mod, (p - spec.R_mod) % p)[:n]):
        lim[:, k] = spec.to_limbs(v)
    return lim.astype(np.int32)


def affine_host(P, idx=None):
    """Jacobian [24, B] x 3 tensors -> host affine points (None = infinity)."""
    from tokamak_zk_evm_tpu_torch.fields import FQ, Q_MOD

    cols = [c.cpu().numpy() for c in P]
    B = cols[0].shape[1]
    out = []
    for i in (range(B) if idx is None else idx):
        X, Y, Z = (FQ.from_mont(FQ.from_limbs(c[:, i])) for c in cols)
        if Z == 0:
            out.append(None)
            continue
        zi = pow(Z, -1, Q_MOD)
        out.append((X * zi * zi % Q_MOD, Y * zi * zi * zi % Q_MOD))
    return out


def rows_affine(rows):
    from tokamak_zk_evm_tpu_torch.fields import FQ
    from tokamak_zk_evm_tpu_torch.host.curve import G1

    X, Y, Z = (FQ.from_mont(FQ.from_limbs(r.tolist())) for r in rows)
    return G1.to_affine((X, Y, Z))


# ---------------------------------------------------------------------------
# phase 3: kernel checks
# ---------------------------------------------------------------------------


def check_kernels(torch, np, K, dev):
    from tokamak_zk_evm_tpu_torch.fields import FQ, FR, R_MOD
    from tokamak_zk_evm_tpu_torch.host.curve import G1
    from tokamak_zk_evm_tpu_torch.ops import field as F
    from tokamak_zk_evm_tpu_torch.ops import ntt as NT

    rng = np.random.default_rng(1)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    log("[3] K1 field_ew: kernel == plain, exact")
    for field, spec in ((0, FR), (1, FQ)):
        n = 3 * 4099
        a = T(rand_field(np, rng, spec, n))
        forms = {
            "equal": (T(rand_field(np, rng, spec, n)), 1),
            "scalar": (T(rand_field(np, rng, spec, 1)), 1),
            "cyclic": (T(rand_field(np, rng, spec, 4099)), 1),
            "block": (T(rand_field(np, rng, spec, 3)), 4099),
        }
        for op in ("add", "sub", "mul"):
            for form, (b, rep) in forms.items():
                got = K._field_ew(field, op, a, b, rep)
                want = K.plain_field_ew(field, op, a, b, rep)
                expect(torch.equal(got, want), f"{spec.name} {op} ({form})")
        expect(torch.equal(K._field_ew(field, "neg", a), K.plain_field_ew(field, "neg", a)),
               f"{spec.name} neg")
    torch.cuda.synchronize()

    log("[3] K2 field_inv / batch_inv: kernel == plain, exact (0 -> 0)")
    for field, spec in ((0, FR), (1, FQ)):
        a = T(rand_field(np, rng, spec, 4096))
        expect(torch.equal(K.field_inv(field, a), K.plain_field_inv(field, a)),
               f"{spec.name} Fermat inverse, 4096")
        n = (1 << 20) if field == 0 else (1 << 16) + 5
        a = rand_field(np, rng, spec, n)
        a[:, rng.integers(0, n, size=97)] = 0
        a = T(a)
        got = K.batch_inv(field, a)
        expect(torch.equal(got, K.plain_batch_inv(field, a)),
               f"{spec.name} batch inverse, {n} with zeros")
        one = K.plain_field_ew(field, "mul", a, got)
        nz = (a != 0).any(0)
        mont_one = T(np.asarray(spec.to_limbs(spec.R_mod), np.int32)[:, None])
        expect(bool((one[:, nz] == mont_one).all()), f"{spec.name} a * a^-1 == 1")

    log("[3] K3 ntt at 16384 x 512: kernel == plain, exact")
    grid = T(rand_field(np, rng, FR, 16384 * 512).reshape(16, 16384, 512))
    for n, batch in ((16384, 512), (512, 16384)):
        data = (grid.transpose(1, 2) if n == 16384 else grid).contiguous()
        data = data.reshape(16, batch, n)
        for inverse in (False, True):
            pows, scale = NT._tables(n, inverse, dev)
            got = K.fr_ntt(data, pows, scale)
            want = K.plain_ntt(data, pows, scale)
            expect(torch.equal(got, want),
                   f"n={n} batch={batch} {'inverse' if inverse else 'forward'}")
            del got, want
    ev = NT.bintt(grid, coset_x=7, coset_y=5)
    expect(torch.equal(ev, plain_bintt(torch, K, F, grid, False, 7, 5)),
           "bintt forward, cosets (7, 5): kernels == plain")
    back = NT.bintt(ev, inverse=True, coset_x=7, coset_y=5)
    expect(torch.equal(back, plain_bintt(torch, K, F, ev, True, 7, 5)),
           "bintt inverse, cosets (7, 5): kernels == plain")
    expect(torch.equal(back, grid), "bintt coset (7, 5) inverse undoes forward")
    del grid, ev, back
    torch.cuda.empty_cache()

    log("[3] K4 g1_fixed_base at 2^12: kernel == plain (same affine points)")
    n = 1 << 12
    sc = rand_field(np, rng, FR, n)
    sc[:, :3] = 0
    sc[:, 3] = FR.to_limbs(1)
    sc[:, 4] = FR.to_limbs(R_MOD - 1)
    sc = T(sc)
    tx, ty, tinf = K.fixed_base_table(*G1.gen, dev)
    got = affine_host(K.g1_fixed_base(sc, tx, ty, tinf))
    want = affine_host(K.plain_g1_fixed_base(sc, tx, ty, tinf))
    expect(got == want, "fixed-base 4096 scalars")
    host = [FR.from_limbs(sc[:, i].tolist()) for i in range(8)]
    expect(got[:8] == [G1.to_affine(G1.scalar_mul(G1.from_affine(G1.gen), k)) for k in host],
           "fixed-base agrees with host scalar muls")

    log("[3] K4 MSM at 2^12: kernel == plain == oracle")
    msm_oracle_check(torch, np, K, dev, rng, 1 << 12, plain=True)
    log("[3] K4 MSM at 2^22 against the O(1) oracle")
    msm_oracle_check(torch, np, K, dev, rng, 1 << 22, plain=False)


def plain_bintt(torch, K, F, grid, inverse, cx, cy):
    """ops.ntt.bintt with the plain versions of K1 (coset scaling) and K3."""
    from tokamak_zk_evm_tpu_torch.fields import R_MOD
    from tokamak_zk_evm_tpu_torch.ops import ntt as NT

    def batched(a, coset):
        L, rows, n = a.shape
        flat = a.reshape(L, -1)
        c = pow(coset, -1, R_MOD) if inverse else coset
        pw = F.tensor(F.fr_powers(c, n), a.device)
        if not inverse:
            flat = K.plain_field_ew(0, "mul", flat, pw)
        pows, scale = NT._tables(n, inverse, a.device)
        out = K.plain_ntt(flat.reshape(L, rows, n), pows, scale).reshape(L, -1)
        if inverse:
            out = K.plain_field_ew(0, "mul", out, pw)
        return out.reshape(L, rows, n)

    g = batched(grid, cy)
    g = batched(g.transpose(1, 2).contiguous(), cx)
    return g.transpose(1, 2).contiguous()


def oracle_inputs(torch, np, K, dev, rng, n):
    """Points c_i G (c_i from a small set, so points repeat; c_i = 0 gives
    infinity) and scalars k_i (some zero, one r-1); returns the device
    inputs and the host oracle point (sum k_i c_i) G."""
    from tokamak_zk_evm_tpu_torch.fields import FR, R_MOD
    from tokamak_zk_evm_tpu_torch.host.curve import G1

    c = (np.arange(n, dtype=np.int64) * 7919) % 997
    c[rng.integers(0, n, size=17)] = 0
    cl = np.zeros((16, n), np.int32)
    cl[0] = c
    tx, ty, tinf = K.fixed_base_table(*G1.gen, dev)
    px, py, pinf = K.g1_to_affine(K.g1_fixed_base(torch.as_tensor(cl, device=dev), tx, ty, tinf))
    k = rand_field(np, rng, FR, n)
    k[:, rng.integers(0, n, size=31)] = 0
    k[:, 5] = FR.to_limbs(R_MOD - 1)
    acc = 0
    for j in range(16):
        acc += int((k[j].astype(np.int64) * c).sum()) << (16 * j)
    want = G1.to_affine(G1.scalar_mul(G1.from_affine(G1.gen), acc % R_MOD))
    return torch.as_tensor(k, device=dev), px, py, pinf, want


def msm_oracle_check(torch, np, K, dev, rng, n, plain):
    k, px, py, pinf, want = oracle_inputs(torch, np, K, dev, rng, n)
    got = rows_affine(K.g1_msm(k, px, py, pinf))
    expect(got == want, f"MSM {n} points == (sum k_i c_i) G")
    if plain:
        pl = rows_affine(K.g1_msm_finish(K.plain_g1_msm_start(k, px, py, pinf)))
        expect(pl == got, f"MSM {n} points: kernel stages == plain stages")
        c, nwin, pidx, bucket, counts = K.msm_plan(k, pinf)
        start, length, _ = K.chunk_segments(counts)
        pin = pinf.to(torch.int32).contiguous()
        a = affine_host(K.msm_bucket_sum(0, px, py, pin, pidx, start, length))
        b = affine_host(K.plain_msm_bucket_sum(0, px, py, pin, pidx, start, length))
        expect(a == b, f"msm_bucket_sum kernel == plain ({start.shape[0]} chunks)")


# ---------------------------------------------------------------------------
# phases 4 and 5: proofs
# ---------------------------------------------------------------------------


def prove_toy(np, dev):
    from tokamak_zk_evm_tpu_torch.io.artifacts import canonical_proof_bytes
    from tokamak_zk_evm_tpu_torch.models.preprocess import preprocess
    from tokamak_zk_evm_tpu_torch.models.protocol import Mixer
    from tokamak_zk_evm_tpu_torch.models.prover import Prover
    from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
    from tokamak_zk_evm_tpu_torch.models.verifier import Verifier
    from tokamak_zk_evm_tpu_torch.testing.fixtures import GOLDEN_PROOF_SHA256, build_fixture

    fx = build_fixture()
    sigma = generate_sigma(fx.params, Tau.fixed(), fx.library, fx.infos, device=dev)
    proof, _ = Prover(fx.params, sigma, fx.library, fx.infos, fx.placements, fx.permutation,
                      fx.instance, mixer=Mixer.zero(), device=dev).prove()
    digest = hashlib.sha256(canonical_proof_bytes(proof)).hexdigest()
    expect(digest == GOLDEN_PROOF_SHA256, f"toy proof digest {digest[:16]}... is the pinned one")
    pre = preprocess(sigma, fx.permutation, fx.instance, fx.params, device=dev)
    ok = Verifier(fx.params, sigma, pre, fx.instance, proof, rng=np.random.default_rng(7),
                  device=dev).verify_snark()
    expect(ok is True, "toy proof verifies (port Verifier)")


def prove_full(torch, np, K, dev):
    from tokamak_zk_evm_tpu_torch.models.preprocess import preprocess
    from tokamak_zk_evm_tpu_torch.models.protocol import Mixer
    from tokamak_zk_evm_tpu_torch.models.prover import Prover
    from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
    from tokamak_zk_evm_tpu_torch.models.verifier import Verifier
    from tokamak_zk_evm_tpu_torch.testing.synthetic import build_synthetic
    from tokamak_zk_evm_tpu_torch.utils import timing

    t0 = time.perf_counter()
    fx = build_synthetic()
    p = fx.params
    log(f"  fixture n={p.n} s_max={p.s_max} m_i={p.m_i} m_D={p.m_D} "
        f"placements={len(fx.placements)} built in {time.perf_counter() - t0:.3f} s (host)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timing.reset()
    K.reset_counts()
    t = {}
    t0 = time.perf_counter()
    sigma = generate_sigma(p, Tau.fixed(), fx.library, fx.infos, device=dev)
    torch.cuda.synchronize()
    t["setup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prover = Prover(p, sigma, fx.library, fx.infos, fx.placements, fx.permutation, fx.instance,
                    mixer=Mixer.random(np.random.default_rng(3)), device=dev)
    torch.cuda.synchronize()
    t["init"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof, _ = prover.prove()
    torch.cuda.synchronize()
    t["prove"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pre = preprocess(sigma, fx.permutation, fx.instance, p, device=dev)
    ok = Verifier(p, sigma, pre, fx.instance, proof, rng=np.random.default_rng(7),
                  device=dev).verify_snark()
    t["verify"] = time.perf_counter() - t0
    counts = K.counts()
    peak = torch.cuda.max_memory_allocated()
    spans = timing.summarize()["by_name"]
    log("  seconds: " + json.dumps({k: round(v, 3) for k, v in t.items()}))
    log("  spans (s): " + json.dumps({k: round(v, 3) for k, v in spans.items()}))
    log("  kernels " + json.dumps(counts))
    log(f"  peak device memory {peak / 2**30:.3f} GiB")
    expect(ok is True, "full-shape proof verifies (port Verifier)")
    for name, c in counts.items():
        expect(c > 0, f"kernel {name} launched {c} times on the main path")
    del prover, sigma
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 6: timings and bounds
# ---------------------------------------------------------------------------

FR_MUL_OPS = 2 * (2 * 8 * 8 + 8)  # 32-bit CIOS multiply-adds, x2 ops each
FQ_MUL_OPS = 2 * (2 * 12 * 12 + 12)
MIXED_ADD_MULS = 11
JAC_ADD_MULS = 16


def limbs_err(a, b) -> int:
    """Largest limb difference between two outputs (0 = byte-equal)."""
    return int((a.long() - b.long()).abs().max())


def points_err(K, p, q) -> int:
    """Largest limb difference between the cross-multiplied coordinates of
    two jacobian outputs, X1 Z2^2 against X2 Z1^2 and Y1 Z2^3 against
    Y2 Z1^3 (0 = the same points, whatever their representation); a point
    at infinity on one side only counts as 2^16. Plain Fq products on the
    card, over every output."""
    def mul(a, b):
        return K.plain_field_ew(1, "mul", a, b)

    (X1, Y1, Z1), (X2, Y2, Z2) = p, q
    z1s, z2s = mul(Z1, Z1), mul(Z2, Z2)
    ex = limbs_err(mul(X1, z2s), mul(X2, z1s))
    ey = limbs_err(mul(Y1, mul(Z2, z2s)), mul(Y2, mul(Z1, z1s)))
    inf_differs = bool(((Z1 == 0).all(0) != (Z2 == 0).all(0)).any())
    return max(ex, ey, (1 << 16) if inf_differs else 0)


def msm_stage_inputs(torch, np, K, dev, rng, n):
    """The level-1 bucket-sum and the window-reduce inputs of one MSM of n
    oracle points: {stage: (kernel fn, plain fn, bytes, ops, shape)}."""
    k, px, py, pinf, _ = oracle_inputs(torch, np, K, dev, rng, n)
    c, nwin, pidx, bucket, cnt = K.msm_plan(k, pinf)
    start, length, _ = K.chunk_segments(cnt)
    pin = pinf.to(torch.int32).contiguous()
    m = int(pidx.shape[0])
    out = {"inputs": (k, px, py, pinf)}
    out["bucket"] = (
        lambda: K.msm_bucket_sum(0, px, py, pin, pidx, start, length),
        lambda: K.plain_msm_bucket_sum(0, px, py, pin, pidx, start, length),
        2 * 96 * n + 8 * m + 16 * start.shape[0] + 3 * 96 * start.shape[0],
        m * MIXED_ADD_MULS * FQ_MUL_OPS, f"2^{n.bit_length() - 1} points, {m} entries")
    # chunks are summed independently: every 64th, for a plain check of a
    # kernel run over all of them
    sel = torch.arange(0, start.shape[0], 64, device=dev)
    out["bucket_every_64th"] = (
        sel, lambda: K.plain_msm_bucket_sum(0, px, py, pin, pidx, start[sel], length[sel]))
    nb = 1 << c
    bx, by, bz = K.segment_sums(K.msm_bucket_sum, 0, px, py, pin, pidx, cnt)
    dense = [t.clone() for t in K._inf(K._OPS_FQ, nwin * nb, dev)]
    for d, v in zip(dense, (bx, by, bz)):
        d[:, bucket] = v
    seg = min(K.MSM_SEG, nb)
    nseg = nwin * nb // seg
    out["window"] = (
        lambda: K.msm_window_reduce(*dense, nwin, nb, seg),
        lambda: K.plain_msm_window_reduce(*dense, nwin, nb, seg),
        3 * 96 * nwin * nb + 3 * 96 * nseg,
        (2 * bucket.shape[0] + 2 * nseg * c) * JAC_ADD_MULS * FQ_MUL_OPS,
        f"{nwin} windows x 2^{c} buckets")
    return out


def bound_ms(nbytes: float, ops: float, ops_per_s: float = PEAK_OPS_PER_S):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def measure(torch, np, K, dev, counts):
    from tokamak_zk_evm_tpu_torch.fields import FQ, FR
    from tokamak_zk_evm_tpu_torch.host.curve import G1
    from tokamak_zk_evm_tpu_torch.ops import ntt as NT

    rng = np.random.default_rng(2)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    rows = []

    def row(kern, shape, fn, plain, nbytes, ops, reps=5, points=False):
        got, want = fn(), plain()
        err = points_err(K, got, want) if points else limbs_err(got, want)
        del got, want
        expect(err == 0, f"{kern.name} {shape}: kernel == plain (max_abs_err {err})")
        ms = cuda_ms(torch, fn, reps, warm=False)  # fn and plain just ran once
        pms = cuda_ms(torch, plain, 1, warm=False)
        b, by = bound_ms(nbytes, ops)
        rows.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": counts[kern.name],
            "max_abs_err": err, "ms": round(ms, 4), "plain_ms": round(pms, 4),
            "bound_ms": round(b, 4), "bound_by": by, "library_ms": None, "shape": shape,
            "imad_bound_ms": round(bound_ms(nbytes, ops, IMAD_PER_S)[0], 4),
        })
        log(f"  {kern.name:18s} {shape:28s} {ms:10.3f} ms  plain {pms:10.3f} ms  "
            f"bound {b:8.4f} ms ({by})")

    n = 1 << 23  # prove2's (4 m_i, 2 s_max) evaluation grids
    a, b = T(rand_field(np, rng, FR, n)), T(rand_field(np, rng, FR, n))
    row(K.FR_EW, "Fr mul 2^23", lambda: K.fr_mul(a, b), lambda: K.plain_field_ew(0, "mul", a, b),
        3 * 64 * n, FR_MUL_OPS * n)
    ms = cuda_ms(torch, lambda: K.fr_neg(a))
    b_neg, _ = bound_ms(2 * 64 * n, 0)
    rows[-1].update({"neg_ms": round(ms, 4), "neg_bound_ms": round(b_neg, 4)})
    log(f"  {'fr_ew':18s} {'Fr neg 2^23':28s} {ms:10.3f} ms  bound {b_neg:8.4f} ms (bytes)")
    del a, b
    n = 1 << 22  # setup's xy_powers family to affine
    a, b = T(rand_field(np, rng, FQ, n)), T(rand_field(np, rng, FQ, n))
    row(K.FQ_EW, "Fq mul 2^22", lambda: K.fq_mul(a, b), lambda: K.plain_field_ew(1, "mul", a, b),
        3 * 96 * n, FQ_MUL_OPS * n)
    del a, b
    n = 4096  # chunk totals of the 2^20 prove1 batch inversion, two levels down
    a = T(rand_field(np, rng, FR, n))
    e = FR.modulus - 2
    fermat = (e.bit_length() + bin(e).count("1")) * FR_MUL_OPS * n
    row(K.FIELD_INV, "Fr Fermat 4096", lambda: K.field_inv(0, a),
        lambda: K.plain_field_inv(0, a), 2 * 64 * n, fermat)
    n = 1 << 20  # prove1 grand-product denominators (m_i * s_max)
    a = T(rand_field(np, rng, FR, n))
    row(K.BATCH_INV, "Fr batch inverse 2^20", lambda: K.batch_inv(0, a),
        lambda: K.plain_batch_inv(0, a), 2 * 64 * n, 3 * FR_MUL_OPS * n)
    del a
    nn, batch = 16384, 512  # the X pass of prove2's largest bivariate NTT
    data = T(rand_field(np, rng, FR, nn * batch).reshape(16, batch, nn))
    pows, scale = NT._tables(nn, False, dev)
    bf = batch * (nn // 2) * 14
    row(K.NTT, "16384 x 512 (n=16384)", lambda: K.fr_ntt(data, pows, scale),
        lambda: K.plain_ntt(data, pows, scale), 2 * 64 * nn * batch,
        (bf + nn * batch) * FR_MUL_OPS)
    del data
    torch.cuda.empty_cache()
    n = 1 << 22  # setup's largest fixed-base family (xy_powers, 8192 x 512)
    sc = T(rand_field(np, rng, FR, n))
    tx, ty, tinf = K.fixed_base_table(*G1.gen, dev)
    digits = sum(int(((sc[w // 2] >> (8 * (w % 2))) & 0xFF).ne(0).sum()) for w in range(32))
    row(K.G1_FIXED_BASE, "2^22 scalars", lambda: K.g1_fixed_base(sc, tx, ty, tinf),
        lambda: K.plain_g1_fixed_base(sc, tx, ty, tinf), 64 * n + 3 * 96 * n,
        digits * MIXED_ADD_MULS * FQ_MUL_OPS, reps=3, points=True)
    del sc
    torch.cuda.empty_cache()
    # The MSM stages at the main path's largest commitment, 2^22 points. The
    # plain bucket sum over all of its chunks would gather 2^26 points
    # (~40 GB of int64 limbs), so there it is held against every 64th chunk
    # of the kernel's output, and timed in full at 2^16 points.
    big = msm_stage_inputs(torch, np, K, dev, rng, 1 << 22)
    small = msm_stage_inputs(torch, np, K, dev, rng, 1 << 16)
    fn, _, nbytes, ops, shape = big["bucket"]
    sel, plain_sel = big["bucket_every_64th"]
    got = fn()
    err = points_err(K, [c[:, sel] for c in got], plain_sel())
    del got
    expect(err == 0, f"msm_bucket_sum {shape}: kernel == plain on every 64th chunk "
           f"({sel.shape[0]} chunks, max_abs_err {err})")
    ms = cuda_ms(torch, fn, 3)
    b, by = bound_ms(nbytes, ops)
    fn_s, plain_s, nbytes_s, ops_s, shape_s = small["bucket"]
    row(K.MSM_BUCKET_SUM, shape_s, fn_s, plain_s, nbytes_s, ops_s, points=True)
    rows[-1].update({"main_path_shape": shape, "main_path_ms": round(ms, 4),
                     "main_path_bound_ms": round(b, 4), "main_path_max_abs_err": err,
                     "main_path_imad_bound_ms": round(bound_ms(nbytes, ops, IMAD_PER_S)[0], 4)})
    log(f"  {K.MSM_BUCKET_SUM.name:18s} {shape:28s} {ms:10.3f} ms  (kernel only)  "
        f"bound {b:8.4f} ms ({by})")
    fn, plain, nbytes, ops, shape = big["window"]
    row(K.MSM_WINDOW, shape, fn, plain, nbytes, ops, reps=3, points=True)
    del small
    k, px, py, pinf = big["inputs"]
    ms = cuda_ms(torch, lambda: K.g1_msm_start(k, px, py, pinf), reps=2)
    log(f"  g1_msm_start (plan + K4 stages) at 2^22 points: {ms:.3f} ms")
    return rows


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "tokamak_zk_evm_tpu_torch", "backend", "csrc")):
        print("chip_smoke: run from a checkout: tokamak_zk_evm_tpu_torch/ is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from tokamak_zk_evm_tpu_torch.backend import build
    from tokamak_zk_evm_tpu_torch.backend import kernels as K

    t_all = time.perf_counter()
    log("[1] " + gpu_line())
    dev = torch.device("cuda")
    log(f"    torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    took = build.build_all()
    log(f"[2] built {sorted(took)} in {time.perf_counter() - t0:.3f} s")
    for name in build.SIGNATURES:
        with open(os.path.join(build.BUILD_DIR, f"{name}.log")) as f:
            for line in f:
                spilled = "spill stores" in line and " 0 bytes spill stores" not in line
                if "registers" in line or spilled:
                    log(f"    {name}: {line.strip()}")

    check_kernels(torch, np, K, dev)

    log("[4] golden toy proof on the card")
    t0 = time.perf_counter()
    prove_toy(np, dev)
    log(f"    {time.perf_counter() - t0:.3f} s")

    log("[5] main path: synthetic full shape on the card")
    counts = prove_full(torch, np, K, dev)
    log("[6] kernel times (CUDA events) beside plain versions and bounds")
    kernels_line = json.dumps({"kernels": measure(torch, np, K, dev, counts)})

    log(f"total {time.perf_counter() - t_all:.3f} s")
    print(gpu_line())
    print(kernels_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
