#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with one NVIDIA GPU and no arguments:

    python3 chip_smoke.py

Phases, in order (any mismatch or exception exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of the port from `tokamak_zk_evm_tpu_torch/backend/csrc`
     (one nvcc per source, all at once), print each kernel's ptxas registers
     and stack frame, and require that the MSM build reports exactly its
     three stage kernels (the bucket sum's two passes and the window
     reduce), the NTT build its pass kernel, the G1 build its fixed-base
     kernel, the G1 ops build B13's three (add, doubling, to-affine), the
     inversion build its six (three a field) and the scan build B6's three
     (tile totals, their scan, the tiles), each with no stack frame and no
     spills;
  3. each kernel against its plain PyTorch version on the card, exact:
     K1 on Fr and Fq batches holding 0, 1 and p-1; K2's inversion at 1 and
     4096 elements and its batch inversion at 1, 2, its one-launch width
     +-1, a tile past it, 2^20 (Fr) and 2^22 (Fq), with zeros at tile and
     warp edges, and on all-zero batches, each also against host inverses
     (`pow`) on a sample, a * a^-1 == 1, and one launch or three; B6's
     prefix and suffix scans at 1, 2, a tile +-1, two tiles + 1 and 2^20,
     without zeros and with zeros at thread, warp and tile edges, and on
     zeros alone, one launch or three; K3
     forward and inverse
     along both axes of a 16384 x 512 grid, on transforms past 16384 points
     (rows of 2^20, columns of 2^18), on a 2^23-point row and column (past
     the kernel's two passes: `fr_ntt`'s four-step split, two K3 calls and a
     K1 twiddle product), and a coset round trip (K1 and K3); B13's
     g1_add, g1_dbl and g1_to_affine (one launch each, the last after K2)
     with every case planted (P+Q, P+P, P+(-P), inf+Q, P+inf, inf+inf, a
     broadcast operand), on doubled points and on raw ones whose
     infinities are (0, 0, 0); K4
     fixed-base at 2^12 with planted scalars (0, 1, r-1, all-ones digits, a
     nonzero top window alone, repeats) on the 12-bit table built on the
     card, against the plain version on the 8-bit table and host scalar
     muls, and a sample of the 12-bit table against host scalar muls; the
     MSM at 2^12 with repeated points, infinities and zero scalars; the MSM
     at 2^22 against the O(1) oracle sum k_i (c_i G) = (sum k_i c_i) G;
  3b. K5's affine-add pair against its plain versions at 2^20 lanes, exact,
     with every case planted (P+Q, P+P, P+(-P), inf+Q, P+inf, inf+inf), and
     a sample of lanes against host curve adds;
  4. the toy proof on the card: its digest must be the pinned one and the
     port's verifier must accept it;
  5. the main path at the synthetic full shape (n=4096, s_max=256,
     m_i=4096) on the default MSM core ("pippenger"): generate_sigma ->
     Prover.prove() -> preprocess -> verify_snark(), with every kernel's
     launch counter set to 0 just before and read just after; every kernel
     of that path (B6's scan included) must have launched, and K5 not at
     all.  The run records
     each distinct call of K3 (grid, axis, tables), the fixed-base op's
     batch sizes and the widths of the batch inversions;
  5c. K3 against its plain version at every call signature phase 5
     recorded, on random grids of those shapes, exact;
  5b. the second MSM core, "affine_tree" (`ops.msm.use_core`): one 2^22-point
     MSM against the Pippenger and the O(1) oracle, then phase 5's path again
     on the same CRS (counters set to 0 before, read after): its proof bytes
     must equal phase 5's, it must verify, and K5 and the batch inversion
     must have launched while K4's MSM stages did not; the widths of its
     batch inversions are counted by power of two;
  5d. the file-contract path: `build_synthetic()` staged as reference-layout
     files (library dir, the synthesizer's three JSONs), then the port's CLI
     (`cli.main`, in this process, counters set to 0 before and read after):
     setup --fixed-tau --format both, preprocess, prove --deterministic,
     verify; both CRS formats must load to phase 5's sigma, proof.json must
     be the in-process Mixer.zero() proof and hash to the JAX package's
     pinned digest, verify must print true and, for a proof with one limb
     changed, false; every kernel of the path but K5 must launch; `python -m
     tokamak_zk_evm_tpu_torch doctor` must pass;
  5e. the MPC ceremony at the synthetic full shape, in process with seeded
     rngs: phase-1 init and two contributions, each verified, the
     accumulator's JSON written and read back (checked); phase-2 prepare
     with a beacon y and two contributions, each verified; the result must
     equal `generate_sigma` for the combined secrets on every family point
     (9,390,208) and every host point; `phase2_verify` must reject one
     point changed in delta_inv_li_o_prv and two xy_powers rows swapped;
     then the CLI's `mpc` steps at the same shape through files (one
     contributor a phase, secure rng), preprocess, prove --deterministic
     and verify (true) on the ceremony's CRS.  Counters set to 0 before,
     read after: B13's kernels, K1, K2 and K4's MSM stages must launch;
  5f. the multi-device path (`parallel/`; the card machine has one GPU, and
     NCCL refuses two ranks on one card): (i) a one-rank NCCL group, on
     which `bintt_dist` at 16384 x 512, forward and inverse, must equal
     `bintt` and `msm_dist` at 2^22 points the unsharded MSM and the O(1)
     oracle, each timed beside its unsharded counterpart; (ii) two spawned
     ranks sharing the card over gloo (collectives through host memory)
     each prove `build_synthetic()` under `use_mesh` with `Mixer.zero()`:
     both proofs must equal phase 5d's and hash to the JAX package's pinned
     digest, verify, and show the dist counters, B6, K3 and K4's MSM stages
     above zero on each rank; each rank's prove seconds, peak memory and
     staged bytes are printed (two ranks on one card: not a scaling
     figure);
  6. each kernel at the main path's shapes: held against its plain version
     there (every output of K1, K2, K3 on both axes, K5, the fixed-base
     kernel at 2^22 (against the plain version on the 8-bit table) and every
     level of the window reduce; every 64th chunk of both passes of the
     2^22-point bucket sum, the affine pass and the jacobian pass over its
     partials, for uniform and for skewed, witness-like scalars, all of it at
     2^16), then timed beside the plain version and its bound; the
     fixed-base kernel also at setup's other family sizes, with the 12-bit
     table's build; the skewed 2^22-point MSM is held against the O(1)
     oracle too, and the window reduce at 8/2 buckets a thread against the
     default; K2's inversion at 4096 and 1 elements, its batch inversion at
     2^20 (Fr), 2^22, 2^10 and 1 (Fq), and one `g1_aff_add_batch` at 2^22
     lanes, each beside its bound; B6's suffix and prefix scans at 2^20
     (round 1's), beside the K1 doubling chain they replaced; B13's add,
     doubling and to-affine at 2^22 lanes.
The last three lines are the nvidia-smi line, the kernels JSON and the device
JSON. The port imports nothing of JAX; neither does this script.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time
import traceback
from datetime import timedelta

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


# kernels whose builds must report no stack frame and no spills, and no other
# function (every device function inlined)
PTXAS_CLEAN = {
    "msm": ("bucket_sum_kernel_affine", "bucket_sum_kernel_jacobian", "window_reduce_kernel"),
    "ntt": ("ntt_pass_kernel",),
    "g1": ("fixed_base_kernel",),
    "g1_ops": ("g1_add_kernel", "g1_dbl_kernel", "g1_affine_kernel"),
    "field_inv": tuple(f"{k}_{f}" for k in ("inv_kernel", "binv_up", "binv_down")
                       for f in ("fr", "fq")),
    "fr_scan": ("scan_up", "scan_top", "scan_tile"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def expect(cond: bool, what: str) -> None:
    if not cond:
        fail(what)
    log(f"  ok  {what}")


def ptxas_frames(path: str) -> dict:
    """{function: (stack frame, spill store, spill load bytes)} from an
    `nvcc -Xptxas -v` log."""
    import re

    out, fn = {}, None
    with open(path) as f:
        for line in f:
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and fn:
                out[fn] = tuple(int(v) for v in m.groups())
    return out


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

    check_inversion(torch, np, K, dev, rng)
    check_scan(torch, K, dev)

    log("[3] K3 ntt at 16384 x 512, both axes: kernel == plain, exact")
    grid = T(rand_field(np, rng, FR, 16384 * 512).reshape(16, 16384, 512))
    for axis in (1, 2):
        n = grid.shape[axis]
        for inverse in (False, True):
            tables = NT._tables(n, inverse, dev)
            got = K.fr_ntt(grid, *tables, axis=axis)
            expect(torch.equal(got, K.plain_ntt(grid, *tables, axis=axis)),
                   f"n={n} axis {axis} {'inverse' if inverse else 'forward'}")
            del got
    for shape, axis in (((2, 1 << 20), 2), ((1 << 18, 16), 1)):
        long = rand_fr(torch, shape, 13, dev)
        for inverse in (False, True):
            # uncached: the main path never holds tables this long, so
            # they must not count in phase 5's peak memory
            tables = NT._tables.__wrapped__(shape[axis - 1], inverse, dev)
            expect(torch.equal(K.fr_ntt(long, *tables, axis=axis),
                               K.plain_ntt(long, *tables, axis=axis)),
                   f"n={shape[axis - 1]} axis {axis} over {list(shape)} "
                   f"{'inverse' if inverse else 'forward'}")
        del long
    check_ntt_past_ceiling(torch, K, dev)
    ev = NT.bintt(grid, coset_x=7, coset_y=5)
    expect(torch.equal(ev, plain_bintt(K, NT, grid, False, 7, 5)),
           "bintt forward, cosets (7, 5): kernel == plain")
    back = NT.bintt(ev, inverse=True, coset_x=7, coset_y=5)
    expect(torch.equal(back, plain_bintt(K, NT, ev, True, 7, 5)),
           "bintt inverse, cosets (7, 5): kernel == plain")
    expect(torch.equal(back, grid), "bintt coset (7, 5) inverse undoes forward")
    del grid, ev, back
    torch.cuda.empty_cache()

    log("[3] K4 g1_fixed_base at 2^12: kernel on the 12-bit table == plain on the 8-bit one "
        "(affine points)")
    t0 = time.perf_counter()
    wide = K.fixed_base_table(*G1.gen, dev)
    torch.cuda.synchronize()
    log(f"  12-bit table {tuple(wide.shape)} built on the card in "
        f"{time.perf_counter() - t0:.3f} s (with the 8-bit host table)")
    n = 1 << 12
    sc = rand_field(np, rng, FR, n)
    planted = [0, 1, R_MOD - 1, (1 << 252) - 1] + [d << 252 for d in range(1, 8)]
    for i, k in enumerate(planted):  # zero, one, r - 1, all-ones digits, top window only
        sc[:, i] = FR.to_limbs(k)
    sc[:, 100:164] = sc[:, 20:21]  # one scalar repeated
    sc = T(sc)
    got = affine_host(K.g1_fixed_base(sc, wide))
    want = affine_host(K.plain_g1_fixed_base(sc, K.fixed_base_table(*G1.gen, dev, 8), 8))
    expect(got == want, "fixed-base 4096 scalars, planted")
    host = [FR.from_limbs(sc[:, i].tolist()) for i in range(16)]
    expect(got[:16] == [G1.to_affine(G1.scalar_mul(G1.from_affine(G1.gen), k)) for k in host],
           "fixed-base agrees with host scalar muls")
    X, Y = (c.cpu() for c in K.unpack_points(wide, 2))
    entries = [0, 1, 4095, 4096, 21 * 4096 + 7] + rng.integers(0, 22 * 4096, 16).tolist()
    ok = True
    for e in entries:
        w, d = divmod(int(e), 4096)
        x, y = (FQ.from_mont(FQ.from_limbs(c[:, e].tolist())) for c in (X, Y))
        want = G1.to_affine(G1.scalar_mul(G1.from_affine(G1.gen), (d << (12 * w)) % R_MOD))
        ok &= (None if x == y == 0 else (x, y)) == want
    expect(ok, f"12-bit table == host scalar muls on {len(entries)} entries")

    log("[3] K4 MSM at 2^12: kernel == plain == oracle")
    msm_oracle_check(torch, np, K, dev, rng, 1 << 12, plain=True)
    log("[3] K4 MSM at 2^22 against the O(1) oracle")
    msm_oracle_check(torch, np, K, dev, rng, 1 << 22, plain=False)


def long_ntt_tables(torch, K, n, inverse, dev):
    """(pows, scale) of an n-point transform, the twiddles formed on the card
    as plain products w^(a 2^12) * w^b of two host tables (a host table of
    2^23 powers takes tens of seconds to pack)."""
    from tokamak_zk_evm_tpu_torch.fields import R_MOD, fr_root_of_unity
    from tokamak_zk_evm_tpu_torch.ops import field as F

    w = fr_root_of_unity(n)
    if inverse:
        w = pow(w, -1, R_MOD)
    lo = F.tensor(F.fr_powers(w, 1 << 12), dev)
    hi = F.tensor(F.fr_powers(pow(w, 1 << 12, R_MOD), n >> 12), dev)
    pows = K.plain_field_ew(0, "mul", hi.repeat_interleave(1 << 12, dim=1).contiguous(), lo)
    scale = F.tensor(F.fr_mont(pow(n, -1, R_MOD)), dev) if inverse else None
    return pows, scale


def check_ntt_past_ceiling(torch, K, dev, n=1 << 23):
    """K3 past its two passes: a 2^23-point axis (the four-step split over
    two K3 calls and a K1 twiddle product), forward along rows and inverse
    along a column, against the plain version, exact."""
    for shape, axis, inverse in (((1, n), 2, False), ((n, 1), 1, True)):
        data = rand_fr(torch, shape, 17 + axis, dev)
        pows, scale = long_ntt_tables(torch, K, n, inverse, dev)
        before = K.NTT.launches
        got = K.fr_ntt(data, pows, scale, axis=axis)
        calls = K.NTT.launches - before
        expect(torch.equal(got, K.plain_ntt(data, pows, scale, axis)),
               f"n=2^{n.bit_length() - 1} axis {axis} {'inverse' if inverse else 'forward'} (split, {calls} K3 "
               f"launches): kernel == plain")
        del data, got, pows, scale
    torch.cuda.empty_cache()


def check_curve_ops(torch, np, K, dev, n=6 * 4096):
    """B13's g1_add, g1_dbl and g1_to_affine on the card against their plain
    versions, exact, one launch each: lane i takes case i % 6 of P+Q, P+P,
    P+(-P), inf+Q, P+inf, inf+inf, on jacobian points with Z != 1 (doubled
    affine points) and on the raw affine ones (Z = 1, infinity (0, 0, 0));
    the add also with its second operand broadcast (rep 4); and a sample
    of lanes against host curve adds."""
    from tokamak_zk_evm_tpu_torch.host.curve import G1

    log(f"[3] B13 g1_add / g1_dbl / g1_to_affine at {n} lanes, every case planted: "
        f"kernels == plain, exact")
    x1, y1, x2, y2 = planted_affine(torch, np, K, dev, np.random.default_rng(6), n, "all")

    def raw(x, y):
        inf = (x == 0).all(0) & (y == 0).all(0)
        one = K._FQ.one(dev).expand(K.FQ_L, n).to(torch.int32)
        return x, y, torch.where(inf[None, :], torch.zeros_like(one), one).contiguous()

    same = lambda a, b: all(torch.equal(u, v) for u, v in zip(a, b))  # noqa: E731
    for form, (P, Q) in (("doubled", (K.plain_g1_dbl(raw(x1, y1)), K.plain_g1_dbl(raw(x2, y2)))),
                         ("raw", (raw(x1, y1), raw(x2, y2)))):
        before = {k.name: k.launches for k in (K.G1_ADD, K.G1_DBL, K.G1_TO_AFFINE)}
        S = K.g1_add(P, Q)
        D = K.g1_dbl(P)
        A = K.g1_to_affine(S)
        one_each = all(k.launches - before[k.name] == 1 for k in (K.G1_ADD, K.G1_DBL, K.G1_TO_AFFINE))
        expect(same(S, K.plain_g1_add(P, Q)) and one_each,
               f"g1_add kernel == plain ({form} inputs), one launch each")
        Qr = tuple(c[:, : n // 4].contiguous() for c in Q)
        expect(same(K.g1_add(P, Qr, rep=4), K.plain_g1_add(P, Qr, rep=4)),
               f"g1_add, second operand broadcast (rep 4) == plain ({form} inputs)")
        expect(same(D, K.plain_g1_dbl(P)), f"g1_dbl kernel == plain ({form} inputs)")
        expect(same(A, K.plain_g1_to_affine(S)), f"g1_to_affine kernels == plain ({form} inputs)")
        expect(bool((A[2].view(-1, 6)[:, 2] == 1).all()) and bool((A[2].view(-1, 6)[:, 5] == 1).all()),
               f"P+(-P) and inf+inf lanes are infinity ({form} inputs)")
    m = min(n, 300)
    idx = list(range(m))
    want = [G1.to_affine(G1.add(G1.from_affine(p), G1.from_affine(q)))
            for p, q in zip(affine_host(P, idx), affine_host(Q, idx))]
    expect(affine_host(S, idx) == want, f"g1_add == host curve adds on {m} lanes")
    del x1, y1, x2, y2, P, Q, S, D, A
    torch.cuda.empty_cache()


def host_inverses_match(spec, a, out, idx) -> bool:
    """out[:, i] is the Montgomery form of a_i^-1 (0 -> 0) for every i in
    idx, by host `pow`."""
    A, O = a[:, idx].cpu().numpy(), out[:, idx].cpu().numpy()
    for j in range(len(idx)):
        x = spec.from_mont(spec.from_limbs(A[:, j].tolist()))
        want = spec.to_mont(pow(x, -1, spec.modulus)) if x else 0
        if spec.from_limbs(O[:, j].tolist()) != want:
            return False
    return True


def inversion_batch(np, rng, spec, n: int):
    """`rand_field` with a random nonzero element first when n < 6 (its
    column 0 holds 0)."""
    if n >= 6:
        return rand_field(np, rng, spec, n)
    return np.ascontiguousarray(rand_field(np, rng, spec, n + 5)[:, 5:])


def check_inversion(torch, np, K, dev, rng):
    """K2 against its plain version and host inverses: the per-element
    inversion, and the batch inversion on each side of the one-launch tile,
    at the main path's widths, with zeros at tile and warp edges, and on
    all-zero batches; a * a^-1 == 1 wherever a != 0."""
    from tokamak_zk_evm_tpu_torch.fields import FQ, FR

    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    log("[3] K2 field_inv / batch_inv: kernel == plain == host pow, exact (0 -> 0)")
    for field, spec in ((0, FR), (1, FQ)):
        mont_one = T(np.asarray(spec.to_limbs(spec.R_mod), np.int32)[:, None])
        for n in (1, 4096):
            a = T(inversion_batch(np, rng, spec, n))
            got = K.field_inv(field, a)
            idx = list(range(min(n, 64)))
            expect(torch.equal(got, K.plain_field_inv(field, a))
                   and host_inverses_match(spec, a, got, idx),
                   f"{spec.name} inverse, {n} (== plain, == host pow on {len(idx)})")
        each = K.BINV_EACH[field]
        sizes = [1, 2, each - 1, each, each + 1]
        sizes += [each + K.BINV_THREADS * K.binv_per_thread(field, each + 1) + 1]
        sizes += [1 << 20] if field == 0 else [1 << 22]
        for n in sizes:
            a = inversion_batch(np, rng, spec, n)
            tile = K.BINV_THREADS * K.binv_per_thread(field, n)
            edges = [e for b in range(0, n + tile, tile) for e in (b - 1, b, b + 31, b + 32)
                     if 0 <= e < n] if n > 2 else []
            a[:, edges] = 0
            a[:, rng.integers(0, n, size=n // 1000)] = 0
            a = T(a)
            before = K.BATCH_INV.launches + K.FIELD_INV.launches
            got = K.batch_inv(field, a)
            launches = K.BATCH_INV.launches + K.FIELD_INV.launches - before
            idx = sorted(set(range(min(n, 8))) | set(edges[:24])
                         | set(rng.integers(0, n, size=min(n, 32)).tolist()))
            expect(torch.equal(got, K.plain_batch_inv(field, a))
                   and host_inverses_match(spec, a, got, idx)
                   and launches == (1 if n <= each else 3),
                   f"{spec.name} batch inverse, {n} with {len(edges)} zeros at tile edges: "
                   f"== plain, == host pow on {len(idx)}, {launches} launch(es)")
            nz = (a != 0).any(0)
            one = K.plain_field_ew(field, "mul", a, got)
            expect(bool((one[:, nz] == mont_one).all()) and bool((got[:, ~nz] == 0).all()),
                   f"{spec.name} batch inverse, {n}: a * a^-1 == 1, 0 -> 0")
            del a, got, one
        for n in (5, each + 1):
            z = torch.zeros((spec.n_limbs, n), dtype=torch.int32, device=dev)
            got = K.batch_inv(field, z)
            expect(torch.equal(got, z) and torch.equal(got, K.plain_batch_inv(field, z)),
                   f"{spec.name} batch inverse of {n} zeros is {n} zeros")
    torch.cuda.empty_cache()


def check_scan(torch, K, dev):
    """B6 against its plain version, prefix and suffix, exact: at widths on
    both sides of one tile (one launch) and past it (three), without zeros,
    with zeros at thread (8 positions), warp (256) and tile (1024) edges in
    the second half of the scan order, and on zeros alone."""
    from tokamak_zk_evm_tpu_torch.backend import build

    tile = K.SCAN_TILE
    expect(build.lib("fr_scan").tzk_fr_scan_tile() == tile,
           f"fr_scan.cu's tile == kernels.SCAN_TILE ({tile})")
    log("[3] B6 fr_scan: kernel == plain, exact")
    for n in (1, 2, tile - 1, tile, tile + 1, 2 * tile + 1, 1 << 20):
        base = rand_fr(torch, (n,), 40 + n % 97, dev)
        for reverse in (False, True):
            edges = [e for b in range(0, n, tile) for e in (b + 7, b + 8, b + 255, b + 256,
                                                            b + tile - 1)
                     if e < n and (e >= n // 2) != reverse]
            zeroed = base.clone()
            zeroed[:, edges] = 0
            for a, what in ((base, "no zeros"), (zeroed, f"{len(edges)} zeros at edges")):
                before = K.FR_SCAN.launches
                got = K.fr_scan(a, reverse)
                launches = K.FR_SCAN.launches - before
                expect(torch.equal(got, K.plain_fr_scan(a, reverse))
                       and launches == (1 if n <= tile else 3),
                       f"{'suffix' if reverse else 'prefix'} scan of {n} ({what}) == plain, "
                       f"{launches} launch(es)")
        del base
    z = torch.zeros((16, tile + 1), dtype=torch.int32, device=dev)
    expect(torch.equal(K.fr_scan(z), z) and torch.equal(K.fr_scan(z, True), z),
           f"scans of {tile + 1} zeros are zeros")
    torch.cuda.empty_cache()


def plain_bintt(K, NT, grid, inverse, cx, cy):
    """ops.ntt.bintt through the plain versions of K1 and K3: each axis's
    coset table multiplies before a forward transform, its inverse after an
    inverse one."""
    from tokamak_zk_evm_tpu_torch.fields import R_MOD

    for axis, c in ((2, cy), (1, cx)):
        n = grid.shape[axis]
        rep = grid.shape[2] if axis == 1 else 1

        def times(g, v):
            t = NT._coset_table(n, v, g.device)
            return K.plain_field_ew(0, "mul", g.reshape(16, -1), t, rep).reshape(g.shape)

        if c is not None and not inverse:
            grid = times(grid, c)
        grid = K.plain_ntt(grid, *NT._tables(n, inverse, grid.device), axis=axis)
        if c is not None and inverse:
            grid = times(grid, pow(c, -1, R_MOD))
    return grid


def oracle_inputs(torch, np, K, dev, rng, n, skew=False):
    """Points c_i G (c_i from a small set, so points repeat; c_i = 0 gives
    infinity) and scalars k_i (some zero, one r-1); returns the device
    inputs and the host oracle point (sum k_i c_i) G.  skew: small
    witness-like scalars, 90% of them 1 and the rest below 2^16, so one
    bucket holds most entries."""
    from tokamak_zk_evm_tpu_torch.fields import FR, R_MOD
    from tokamak_zk_evm_tpu_torch.host.curve import G1

    c = (np.arange(n, dtype=np.int64) * 7919) % 997
    c[rng.integers(0, n, size=17)] = 0
    cl = np.zeros((16, n), np.int32)
    cl[0] = c
    table = K.fixed_base_table(*G1.gen, dev)
    px, py, pinf = K.g1_to_affine(K.g1_fixed_base(torch.as_tensor(cl, device=dev), table))
    k = rand_field(np, rng, FR, n)
    if skew:
        k[:] = 0
        k[0] = np.where(rng.random(n) < 0.9, 1, rng.integers(0, 1 << 16, size=n))
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
        pts = K.pack_points(px, py)
        a = K.msm_bucket_sum(0, pts, pidx, start, length)
        b = K.plain_msm_bucket_sum(0, pts, pidx, start, length)
        err = packed_err(K, a, b)
        expect(err == 0, f"msm_bucket_sum kernel == plain ({start.shape[0]} chunks, "
               f"max_abs_err {err})")


def planted_affine(torch, np, K, dev, rng, n, mix):
    """Affine operand batches (x1, y1, x2, y2) [24, n] of points a_i G and
    b_i G (a_i < b_i < 2^32, so b_i != +-a_i).  mix "all": lane i takes case
    i % 6 of P+Q, P+P, P+(-P), inf+Q, P+inf, inf+inf ((0, 0) = infinity);
    mix "add": every lane P+Q."""
    from tokamak_zk_evm_tpu_torch.host.curve import G1

    table = K.fixed_base_table(*G1.gen, dev)

    def points(v):
        cl = np.zeros((16, n), np.int32)
        cl[0], cl[1] = v & 0xFFFF, v >> 16
        x, y, _ = K.g1_to_affine(K.g1_fixed_base(torch.as_tensor(cl, device=dev), table))
        return x, y

    a = rng.integers(1, 1 << 31, size=n, dtype=np.int64)
    x1, y1 = points(a)
    x2, y2 = points(a + rng.integers(1, 1 << 20, size=n, dtype=np.int64))
    if mix == "add":
        return x1, y1, x2, y2
    case = torch.arange(n, device=dev) % 6
    sel = lambda m, u, v: torch.where(m[None, :], u, v)  # noqa: E731
    zero = torch.zeros_like(x1)
    x2 = sel((case == 1) | (case == 2), x1, x2)
    y2 = sel(case == 1, y1, sel(case == 2, K.plain_field_ew(1, "neg", y1), y2))
    inf1, inf2 = (case == 3) | (case == 5), (case == 4) | (case == 5)
    return (sel(inf1, zero, x1).contiguous(), sel(inf1, zero, y1).contiguous(),
            sel(inf2, zero, x2).contiguous(), sel(inf2, zero, y2).contiguous())


def check_affine(torch, np, K, dev, n=1 << 20):
    from tokamak_zk_evm_tpu_torch.fields import FQ
    from tokamak_zk_evm_tpu_torch.host.curve import G1

    log(f"[3b] K5 aff_pre / aff_post at {n} lanes, every case planted: kernel == plain, exact")
    x1, y1, x2, y2 = planted_affine(torch, np, K, dev, np.random.default_rng(4), n, "all")
    den = K.aff_pre(x1, y1, x2, y2)
    expect(torch.equal(den, K.plain_aff_pre(x1, y1, x2, y2)), "aff_pre kernel == plain")
    expect(bool((den != 0).any(0).all()), "no slope denominator is zero")
    dinv = K.fq_batch_inv(den)
    got = K.aff_post(x1, y1, x2, y2, dinv)
    want = K.plain_aff_post(x1, y1, x2, y2, dinv)
    expect(all(torch.equal(g, w) for g, w in zip(got, want)), "aff_post kernel == plain")
    m = 600  # 100 lanes of each case against host curve adds

    def host(x, y):
        cols = [c[:, :m].cpu().numpy() for c in (x, y)]
        out = []
        for i in range(m):
            X, Y = (FQ.from_mont(FQ.from_limbs(c[:, i].tolist())) for c in cols)
            out.append(None if X == Y == 0 else (X, Y))
        return out

    want = [G1.to_affine(G1.add(G1.from_affine(p), G1.from_affine(q)))
            for p, q in zip(host(x1, y1), host(x2, y2))]
    expect(host(*got) == want, f"g1_aff_add_batch == host curve adds on {m} lanes")
    del x1, y1, x2, y2, den, dinv, got, want
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 4, 5 and 5b: proofs
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


def synthetic_fixture():
    from tokamak_zk_evm_tpu_torch.testing.synthetic import build_synthetic

    t0 = time.perf_counter()
    fx = build_synthetic()
    p = fx.params
    log(f"  fixture n={p.n} s_max={p.s_max} m_i={p.m_i} m_D={p.m_D} "
        f"placements={len(fx.placements)} built in {time.perf_counter() - t0:.3f} s (host)")
    return fx


def drive(torch, np, K, dev, fx, core, sigma=None):
    """The main path on MSM core `core`: setup (unless `sigma` is given),
    Prover init, prove, preprocess, verify; every launch counter set to 0
    just before and read just after.  -> (sigma, proof bytes, counts)."""
    from tokamak_zk_evm_tpu_torch.io.artifacts import canonical_proof_bytes
    from tokamak_zk_evm_tpu_torch.models.preprocess import preprocess
    from tokamak_zk_evm_tpu_torch.models.protocol import Mixer
    from tokamak_zk_evm_tpu_torch.models.prover import Prover
    from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
    from tokamak_zk_evm_tpu_torch.models.verifier import Verifier
    from tokamak_zk_evm_tpu_torch.ops import msm as TM
    from tokamak_zk_evm_tpu_torch.utils import timing

    p = fx.params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timing.reset()
    K.reset_counts()
    t = {}
    with TM.use_core(core):
        if sigma is None:
            t0 = time.perf_counter()
            sigma = generate_sigma(p, Tau.fixed(), fx.library, fx.infos, device=dev)
            torch.cuda.synchronize()
            t["setup"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        prover = Prover(p, sigma, fx.library, fx.infos, fx.placements, fx.permutation,
                        fx.instance, mixer=Mixer.random(np.random.default_rng(3)), device=dev)
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
    expect(ok is True, f"full-shape proof verifies (port Verifier, MSM core {core})")
    del prover, pre
    torch.cuda.empty_cache()
    return sigma, canonical_proof_bytes(proof), counts


def sigma_equal(torch, a, b) -> bool:
    """Every device family byte-equal and every host point equal."""
    s1, t1 = a.sigma_1, b.sigma_1
    for name in ("xy_powers", "gamma_inv_o_inst", "eta_inv_li_o_inter_alpha4_kj",
                 "delta_inv_li_o_prv"):
        if not all(torch.equal(u, v) for u, v in zip(getattr(s1, name), getattr(t1, name))):
            return False
    host = ("x", "y", "delta", "eta", "delta_inv_alphak_xh_tx", "delta_inv_alpha4_xj_tx",
            "delta_inv_alphak_yi_ty", "h_max", "rs_y")
    return (all(getattr(s1, k) == getattr(t1, k) for k in host)
            and (a.G, a.H, a.lagrange_KL, a.sigma_2) == (b.G, b.H, b.lagrange_KL, b.sigma_2))


def drive_files(torch, np, K, dev, fx, sigma):
    """Phase 5d: the synthetic full shape staged as reference-layout files
    (library dir, the synthesizer's three JSONs) in a scratch directory
    under the checkout's `.cache/`, then the port's CLI in this process:
    setup --fixed-tau --format both, preprocess, prove --deterministic,
    verify; every launch counter set to 0 just before and read just after.
    Then: both CRS formats load to phase 5's `sigma`, proof.json is the
    in-process Mixer.zero() proof on that `sigma` and hashes to the JAX
    package's pinned digest, a proof with one limb changed prints false,
    and `python -m tokamak_zk_evm_tpu_torch doctor` passes.  The directory
    is deleted at the end.  -> (counts, seconds, the Mixer.zero() proof's
    canonical bytes)."""
    import io
    import shutil
    import tempfile

    from tokamak_zk_evm_tpu_torch import cli
    from tokamak_zk_evm_tpu_torch.io import artifacts as art, crs, rkyv_crs
    from tokamak_zk_evm_tpu_torch.models.protocol import Mixer
    from tokamak_zk_evm_tpu_torch.models.prover import Prover
    from tokamak_zk_evm_tpu_torch.testing.synthetic import FULLSHAPE_PROOF_SHA256

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--device", str(dev)] + argv)
        lines = out.getvalue().strip().splitlines()
        return rc, lines[-1] if lines else ""

    cache = os.path.join(ROOT, ".cache")
    os.makedirs(cache, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_5d_", dir=cache)
    try:
        lib, synth, crs_dir, pre, prf = (os.path.join(tmp, d) for d in
                                         ("library", "synthesizer", "crs", "pre", "proof"))
        t0 = time.perf_counter()
        os.makedirs(synth)
        art.save_library(lib, fx.params, fx.infos, fx.library)
        art.save_placement_variables(fx.placements, os.path.join(synth, "placementVariables.json"))
        art.save_instance(fx.instance, os.path.join(synth, "instance.json"))
        art.save_permutation(fx.permutation, os.path.join(synth, "permutation.json"))
        log(f"  staged the library and the synthesizer outputs in "
            f"{time.perf_counter() - t0:.3f} s (host)")
        stages = (
            ("setup", ["setup", "--library", lib, "--output", crs_dir, "--fixed-tau",
                       "--format", "both"]),
            ("preprocess", ["preprocess", "--crs", crs_dir, "--library", lib,
                            "--synthesizer", synth, "--output", pre]),
            ("prove", ["prove", "--crs", crs_dir, "--library", lib, "--synthesizer", synth,
                       "--output", prf, "--deterministic"]),
            ("verify", ["verify", "--crs", crs_dir, "--library", lib, "--preprocess", pre,
                        "--proof", prf, "--synthesizer", synth]),
        )
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_counts()
        t, rcs = {}, {}
        for name, argv in stages:
            t0 = time.perf_counter()
            rcs[name] = run(argv)
            torch.cuda.synchronize()
            t[name] = time.perf_counter() - t0
        counts = K.counts()
        peak = torch.cuda.max_memory_allocated()
        sizes = {f: os.path.getsize(os.path.join(crs_dir, f)) for f in sorted(os.listdir(crs_dir))}
        npy = sum(v for f, v in sizes.items() if f.endswith(".npy"))
        log("  seconds: " + json.dumps({k: round(v, 3) for k, v in t.items()}))
        log(f"  CRS files: npy {npy} B in {sum(f.endswith('.npy') for f in sizes)} files, "
            f"combined_sigma.rkyv {sizes['combined_sigma.rkyv']} B, sigma_preprocess.rkyv "
            f"{sizes['sigma_preprocess.rkyv']} B, sigma_meta.json {sizes['sigma_meta.json']} B, "
            f"sigma_verify.json {sizes['sigma_verify.json']} B")
        log("  kernels " + json.dumps(counts))
        log(f"  peak device memory {peak / 2**30:.3f} GiB")
        for name in ("setup", "preprocess", "prove"):
            expect(rcs[name][0] == 0, f"cli {name} exits 0")
        expect(rcs["verify"] == (0, "true"), "cli verify prints true (exit 0)")

        with open(os.path.join(prf, "proof.json")) as f:
            d = json.load(f)
        bad = {k: list(v) for k, v in d.items()}
        last = int(bad["proof_entries_part2"][-1], 16) ^ 1
        bad["proof_entries_part2"][-1] = "0x" + last.to_bytes(32, "big").hex()
        bad_dir = os.path.join(tmp, "proof_bad")
        os.makedirs(bad_dir)
        with open(os.path.join(bad_dir, "proof.json"), "w") as f:
            json.dump(bad, f)
        rc, out = run(["verify", "--crs", crs_dir, "--library", lib, "--preprocess", pre,
                       "--proof", bad_dir, "--synthesizer", synth])
        expect((rc, out) == (1, "false"), "cli verify of a proof with one limb changed prints "
               "false (exit 1)")

        t0 = time.perf_counter()
        loaded = crs.load_sigma(crs_dir, dev)
        torch.cuda.synchronize()
        log(f"  npy CRS loaded in {time.perf_counter() - t0:.3f} s")
        expect(sigma_equal(torch, loaded, sigma), "npy CRS (crs.load_sigma) == phase 5's sigma")
        del loaded
        t0 = time.perf_counter()
        loaded = rkyv_crs.read_combined_sigma(os.path.join(crs_dir, "combined_sigma.rkyv"),
                                              fx.params, device=dev)
        torch.cuda.synchronize()
        log(f"  combined_sigma.rkyv read in {time.perf_counter() - t0:.3f} s")
        expect(sigma_equal(torch, loaded, sigma),
               "rkyv CRS (rkyv_crs.read_combined_sigma) == phase 5's sigma")
        del loaded
        torch.cuda.empty_cache()

        proof, _ = Prover(fx.params, sigma, fx.library, fx.infos, fx.placements, fx.permutation,
                          fx.instance, mixer=Mixer.zero(), device=dev).prove()
        expect(d == art.proof_to_solidity(proof),
               "proof.json == the in-process Mixer.zero() proof on phase 5's sigma")
        digest = hashlib.sha256(art.canonical_proof_bytes(art.proof_from_solidity(d))).hexdigest()
        expect(digest == FULLSHAPE_PROOF_SHA256,
               f"proof.json digest {digest[:16]}... is the JAX package's pinned one")

        t0 = time.perf_counter()
        doc = subprocess.run([sys.executable, "-m", "tokamak_zk_evm_tpu_torch", "doctor"],
                             cwd=ROOT, capture_output=True, text=True, timeout=300)
        for line in doc.stderr.strip().splitlines():
            log(f"    {line}")
        expect(doc.returncode == 0 and doc.stdout.strip().splitlines()[-1:] == ["true"],
               f"python -m tokamak_zk_evm_tpu_torch doctor prints true, exit 0 "
               f"({time.perf_counter() - t0:.3f} s)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts, t, art.canonical_proof_bytes(proof)


class SeqRng:
    """Seeded bytes: the ceremony's rng, so that its secrets can be replayed."""

    def __init__(self, np, seed):
        self._rng = np.random.default_rng(seed)

    def bytes(self, n):
        return self._rng.bytes(n)


def family_points(sigma) -> int:
    return sum(int(getattr(sigma.sigma_1, f)[2].numel()) for f in
               ("xy_powers", "gamma_inv_o_inst", "eta_inv_li_o_inter_alpha4_kj",
                "delta_inv_li_o_prv"))


def drive_ceremony(torch, np, dev, fx):
    """Phase 5e, in process: the ceremony of `tests/test_mpc_setup.py`'s end
    gate at the synthetic full shape on the card (seeded rngs: the secrets
    are replayed from a second copy of each), every step verified; the
    result against `generate_sigma` for the combined secrets; two tampered
    Sigmas rejected.  -> seconds by stage."""
    import shutil
    import tempfile

    from tokamak_zk_evm_tpu_torch.fields import R_MOD
    from tokamak_zk_evm_tpu_torch.host.curve import G1
    from tokamak_zk_evm_tpu_torch.models import mpc_setup as M
    from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
    from tokamak_zk_evm_tpu_torch.ops import field as F

    p, t = fx.params, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
        return out

    acc = M.Phase1Accumulator.initial(p)
    rng, shadow = SeqRng(np, 7), SeqRng(np, 7)
    alpha = x = 1
    for i in (1, 2):
        new, proof = timed(f"phase1_compute_{i}", lambda: acc.compute(rng, dev))
        ok = timed(f"phase1_verify_{i}",
                   lambda: acc.verify(new, proof, np.random.default_rng(100 + i), dev))
        expect(ok is True, f"phase-1 contribution {i} ({len(new.x_g1)} + 4 + 4 x "
               f"{new.ax_len} G1 powers) verifies")
        a_u, x_u = M._rand_fr(shadow), M._rand_fr(shadow)
        M._rand_fr(shadow), M._rand_fr(shadow)  # the two Schnorr nonces
        alpha, x = alpha * a_u % R_MOD, x * x_u % R_MOD
        acc = new
    cache = os.path.join(ROOT, ".cache")
    os.makedirs(cache, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_5e_", dir=cache)
    try:
        path = os.path.join(tmp, "acc.json")
        timed("phase1_json_save", lambda: acc.save(path))
        loaded = timed("phase1_json_load_checked", lambda: M.Phase1Accumulator.load(path, dev))
        expect(loaded.hash() == acc.hash(), f"phase-1 JSON ({os.path.getsize(path)} B) read "
               f"back through the checked load keeps the hash chain")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    y = 0x1234567
    sigma = timed("phase2_prepare", lambda: M.phase2_prepare(acc, y, p, fx.library, fx.infos,
                                                             dev))
    rng, shadow = SeqRng(np, 9), SeqRng(np, 9)
    gamma = delta = eta = 1
    for i in (1, 2):
        prev = sigma
        sigma, proof = timed(f"phase2_contribute_{i}", lambda: M.phase2_contribute(prev, rng))
        ok = timed(f"phase2_verify_{i}",
                   lambda: M.phase2_verify(prev, sigma, proof, np.random.default_rng(200 + i)))
        expect(ok is True, f"phase-2 contribution {i} verifies")
        g_u, d_u, e_u = (M._rand_fr(shadow) for _ in range(3))
        for _ in range(3):  # the Schnorr nonces
            M._rand_fr(shadow)
        gamma, delta, eta = gamma * g_u % R_MOD, delta * d_u % R_MOD, eta * e_u % R_MOD

    tau = Tau(x=x, y=y, alpha=alpha, gamma=gamma, delta=delta, eta=eta)
    want = timed("generate_sigma", lambda: generate_sigma(p, tau, fx.library, fx.infos,
                                                          device=dev))
    expect(sigma_equal(torch, sigma, want),
           f"ceremony Sigma == generate_sigma(Tau(x, y, alpha, gamma, delta, eta)) on all "
           f"{family_points(sigma)} family points and every host point")
    del want

    import dataclasses

    prv = [c.clone() for c in sigma.sigma_1.delta_inv_li_o_prv]
    k = int(torch.nonzero(prv[2] == 0)[0])
    gen = F.tensor(F.pack_fq([G1.gen[0], G1.gen[1]]), dev)
    prv[0][:, k], prv[1][:, k] = gen[:, 0], gen[:, 1]
    bad = dataclasses.replace(sigma, sigma_1=dataclasses.replace(
        sigma.sigma_1, delta_inv_li_o_prv=tuple(prv)))
    ok = timed("phase2_verify_tampered_prv", lambda: M.phase2_verify(
        prev, bad, proof, np.random.default_rng(300)))
    expect(ok is False, f"phase2_verify rejects delta_inv_li_o_prv with point {k} set to G")
    xy = [c.clone() for c in sigma.sigma_1.xy_powers]
    for c in xy:
        c[..., [0, 1]] = c[..., [1, 0]]
    bad = dataclasses.replace(sigma, sigma_1=dataclasses.replace(
        sigma.sigma_1, xy_powers=tuple(xy)))
    ok = timed("phase2_verify_tampered_xy", lambda: M.phase2_verify(
        prev, bad, proof, np.random.default_rng(301)))
    expect(ok is False, "phase2_verify rejects xy_powers with rows 0 and 1 swapped")
    del prv, xy, bad, sigma, prev
    torch.cuda.empty_cache()
    return t


def drive_ceremony_files(torch, dev, fx):
    """Phase 5e through files: the port's CLI in this process, `mpc`
    phase1-init, phase1-contribute, phase1-verify (true), phase2-prepare,
    phase2-contribute (one contributor a phase, secure rng), then
    preprocess, prove --deterministic and verify (true) on the ceremony's
    CRS, in a scratch directory under the checkout's `.cache/`, deleted at
    the end.  -> seconds by stage."""
    import io
    import shutil
    import tempfile

    from tokamak_zk_evm_tpu_torch import cli
    from tokamak_zk_evm_tpu_torch.io import artifacts as art

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--device", str(dev)] + argv)
        lines = out.getvalue().strip().splitlines()
        return rc, lines[-1] if lines else ""

    cache = os.path.join(ROOT, ".cache")
    os.makedirs(cache, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_5e_", dir=cache)
    t = {}
    try:
        lib, synth = os.path.join(tmp, "library"), os.path.join(tmp, "synthesizer")
        f = lambda name: os.path.join(tmp, name)  # noqa: E731
        os.makedirs(synth)
        art.save_library(lib, fx.params, fx.infos, fx.library)
        art.save_placement_variables(fx.placements, os.path.join(synth, "placementVariables.json"))
        art.save_instance(fx.instance, os.path.join(synth, "instance.json"))
        art.save_permutation(fx.permutation, os.path.join(synth, "permutation.json"))
        stages = (
            ("mpc phase1-init", ["mpc", "phase1-init", "--library", lib, "--output", f("acc0.json")]),
            ("mpc phase1-contribute", ["mpc", "phase1-contribute", "--acc", f("acc0.json"),
                                       "--output", f("acc1.json"), "--proof", f("p1.json")]),
            ("mpc phase1-verify", ["mpc", "phase1-verify", "--prev", f("acc0.json"), "--cur",
                                   f("acc1.json"), "--proof", f("p1.json")]),
            ("mpc phase2-prepare", ["mpc", "phase2-prepare", "--library", lib, "--acc",
                                    f("acc1.json"), "--y-hex", "1234567", "--output", f("crs0")]),
            ("mpc phase2-contribute", ["mpc", "phase2-contribute", "--crs", f("crs0"),
                                       "--output", f("crs1")]),
            ("preprocess", ["preprocess", "--crs", f("crs1"), "--library", lib,
                            "--synthesizer", synth, "--output", f("pre")]),
            ("prove", ["prove", "--crs", f("crs1"), "--library", lib, "--synthesizer", synth,
                       "--output", f("proof"), "--deterministic"]),
            ("verify", ["verify", "--crs", f("crs1"), "--library", lib, "--preprocess", f("pre"),
                        "--proof", f("proof"), "--synthesizer", synth]),
        )
        rcs = {}
        for name, argv in stages:
            t0 = time.perf_counter()
            rcs[name] = run(argv)
            torch.cuda.synchronize()
            t[name] = time.perf_counter() - t0
        log(f"  phase-1 JSON: {os.path.getsize(f('acc1.json'))} B; ceremony CRS npy: "
            f"{sum(os.path.getsize(os.path.join(f('crs1'), n)) for n in os.listdir(f('crs1')))} B")
        for name in ("mpc phase1-init", "mpc phase1-contribute", "mpc phase2-prepare",
                     "mpc phase2-contribute", "preprocess", "prove"):
            expect(rcs[name][0] == 0, f"cli {name} exits 0")
        expect(rcs["mpc phase1-verify"] == (0, "true"), "cli mpc phase1-verify prints true")
        expect(rcs["verify"] == (0, "true"),
               "cli verify prints true for the proof on the ceremony's CRS")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return t


def dist_store(tag: str) -> tuple[str, str]:
    """(scratch dir under the checkout's `.cache/`, a FileStore path in it)
    for one process group."""
    import tempfile

    cache = os.path.join(ROOT, ".cache")
    os.makedirs(cache, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_", dir=cache)
    return tmp, os.path.join(tmp, "store")


def drive_nccl_one(torch, np, K, dev):
    """Phase 5f (i): a one-rank NCCL group (the real collectives, at the
    main path's largest shapes): `bintt_dist` of a 16384 x 512 grid,
    forward and inverse, == `bintt`; `msm_dist` of 2^22 oracle points and
    the unsharded MSM == (sum k_i c_i) G, in turns (dist, MSM, MSM, dist);
    each timed beside its unsharded counterpart.  The group is destroyed before the next phase.  -> stats."""
    import shutil

    import torch.distributed as dist

    from tokamak_zk_evm_tpu_torch.ops import msm as TM
    from tokamak_zk_evm_tpu_torch.ops import ntt as NT
    from tokamak_zk_evm_tpu_torch.parallel import mesh as PM
    from tokamak_zk_evm_tpu_torch.parallel import msm_dist, ntt_dist

    tmp, store = dist_store("5f_nccl")
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1)
    stats = {}
    try:
        mesh = PM.make_mesh(device=dev)
        expect(mesh.backend == "nccl" and mesh.size == 1, "a one-rank NCCL mesh")
        PM.reset_counts()
        grid = rand_fr(torch, (16384, 512), 31, dev)
        for inverse in (False, True):
            tag = "inverse" if inverse else "forward"
            got = ntt_dist.bintt_dist(grid, mesh, inverse)
            expect(torch.equal(got, NT.bintt(grid, inverse=inverse)),
                   f"bintt_dist 16384 x 512 {tag} (NCCL, 1 rank) == bintt, byte for byte")
            del got
            d_ms = cuda_ms(torch, lambda: ntt_dist.bintt_dist(grid, mesh, inverse), 3)
            l_ms = cuda_ms(torch, lambda: NT.bintt(grid, inverse=inverse), 3)
            stats[f"bintt_dist_{tag}_ms"], stats[f"bintt_{tag}_ms"] = round(d_ms, 4), round(l_ms, 4)
            log(f"  bintt_dist 16384 x 512 {tag}: {d_ms:.3f} ms; bintt {l_ms:.3f} ms "
                f"(CUDA events, mean of 3)")
        del grid
        k, px, py, pinf, want = oracle_inputs(torch, np, K, dev, np.random.default_rng(8),
                                              1 << 22)
        runs = {"msm_dist": (lambda: msm_dist.msm_dist(k, px, py, pinf, mesh), []),
                 "msm": (lambda: TM.msm(k, px, py, pinf), [])}
        for name in ("msm_dist", "msm", "msm", "msm_dist"):  # in turns
            fn, times = runs[name]
            t0 = time.perf_counter()
            got = fn()
            times.append(round((time.perf_counter() - t0) * 1e3, 3))
            expect(got == want, f"{name} of 2^22 points (NCCL, 1 rank) == (sum k_i c_i) G")
        log(f"  msm_dist 2^22 points: {runs['msm_dist'][1]} ms; unsharded MSM "
            f"{runs['msm'][1]} ms (host clock, in turns, each ending in the host combine)")
        stats.update({"msm_dist_2^22_ms": runs["msm_dist"][1], "msm_2^22_ms": runs["msm"][1]})
        c = PM.counts()
        expect(c["bintt_dist"] > 0 and c["msm_dist"] > 0, f"dist counters above zero {c}")
        del k, px, py, pinf
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    expect(not dist.is_initialized(), "the NCCL group is destroyed")
    torch.cuda.empty_cache()
    return stats


def dist_rank(rank: int, world: int, store: str, out) -> None:
    """Phase 5f (ii), one rank (a spawned process): join the gloo group,
    build `build_synthetic()`'s CRS on the card (Tau.fixed()), prove under
    `use_mesh` with `Mixer.zero()` (counters set to 0 just before, read
    just after), verify; put the results on `out`."""
    res = {"rank": rank}
    try:
        import numpy as np
        import torch
        import torch.distributed as dist

        sys.path.insert(0, ROOT)
        from tokamak_zk_evm_tpu_torch.backend import kernels as K
        from tokamak_zk_evm_tpu_torch.io.artifacts import canonical_proof_bytes
        from tokamak_zk_evm_tpu_torch.models.preprocess import preprocess
        from tokamak_zk_evm_tpu_torch.models.protocol import Mixer
        from tokamak_zk_evm_tpu_torch.models.prover import Prover
        from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
        from tokamak_zk_evm_tpu_torch.models.verifier import Verifier
        from tokamak_zk_evm_tpu_torch.parallel import context
        from tokamak_zk_evm_tpu_torch.parallel import mesh as PM
        from tokamak_zk_evm_tpu_torch.testing.synthetic import build_synthetic

        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=600))
        mesh = PM.make_mesh()  # cuda:(rank % cards): both ranks on the one card
        dev = mesh.device
        fx = build_synthetic()
        p = fx.params
        sigma = generate_sigma(p, Tau.fixed(), fx.library, fx.infos, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_counts()
        PM.reset_counts()
        with context.use_mesh(mesh):
            t0 = time.perf_counter()
            prover = Prover(p, sigma, fx.library, fx.infos, fx.placements, fx.permutation,
                            fx.instance, mixer=Mixer.zero(), device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            proof, _ = prover.prove()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        res.update(init_s=round(t1 - t0, 3), prove_s=round(t2 - t1, 3), kernels=K.counts(),
                   dist=PM.counts(), peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
                   proof=canonical_proof_bytes(proof), backend=mesh.backend, device=str(dev))
        del prover
        pre = preprocess(sigma, fx.permutation, fx.instance, p, device=dev)
        res["verifies"] = Verifier(p, sigma, pre, fx.instance, proof,
                                   rng=np.random.default_rng(7), device=dev).verify_snark()
        dist.destroy_process_group()
    except Exception:  # reported to the parent, which fails the phase
        res["error"] = traceback.format_exc()[-4000:]
    out.put(res)


def drive_gloo_two(torch, K, want_proof: bytes):
    """Phase 5f (ii): two spawned ranks sharing the one card over gloo,
    each proving the synthetic full shape under the mesh (600 s at most).
    -> each rank's results, in rank order."""
    import queue
    import shutil

    import torch.multiprocessing as mp

    from tokamak_zk_evm_tpu_torch.testing.synthetic import FULLSHAPE_PROOF_SHA256

    world, timeout = 2, 600.0
    tmp, store = dist_store("5f_gloo")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=dist_rank, args=(r, world, store, out)) for r in range(world)]
    got = {}
    t0 = time.perf_counter()
    try:
        for proc in procs:
            proc.start()
        while len(got) < world:
            if time.perf_counter() - t0 > timeout:
                fail(f"phase 5f: {world - len(got)} rank(s) silent after {timeout:.0f} s")
            try:
                res = out.get(timeout=2.0)
                got[res["rank"]] = res
            except queue.Empty:
                dead = [proc.exitcode for proc in procs if proc.exitcode not in (None, 0)]
                if dead:
                    fail(f"phase 5f: a rank exited with code {dead[0]} before reporting")
        for proc in procs:
            proc.join(timeout=60)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  {world} ranks done in {time.perf_counter() - t0:.3f} s (spawn, imports, fixture, "
        f"setup, init, prove, verify)")
    ranks = [got[r] for r in range(world)]
    for res in ranks:
        r = res["rank"]
        expect("error" not in res, f"rank {r} ran" + (f":\n{res['error']}" if "error" in res else ""))
        log(f"  rank {r} ({res['backend']}, {res['device']}; 2 ranks sharing one card, gloo via "
            f"host memory; not a scaling figure): init {res['init_s']} s, prove "
            f"{res['prove_s']} s, peak {res['peak_gib']} GiB, staged "
            f"{res['dist']['staged_bytes']} B, dist calls bintt {res['dist']['bintt_dist']} "
            f"msm {res['dist']['msm_dist']}")
        log(f"  rank {r} kernels " + json.dumps(res["kernels"]))
        digest = hashlib.sha256(res["proof"]).hexdigest()
        expect(res["proof"] == want_proof and digest == FULLSHAPE_PROOF_SHA256,
               f"rank {r}'s sharded proof == phase 5d's Mixer.zero() proof, digest "
               f"{digest[:16]}... the JAX package's pinned one")
        expect(res["verifies"] is True, f"rank {r}'s proof verifies (port Verifier)")
        expect(res["dist"]["bintt_dist"] > 0 and res["dist"]["msm_dist"] > 0
               and res["dist"]["staged_bytes"] > 0,
               f"rank {r}: the sharded path ran (dist counters above zero)")
        expect(all(res["kernels"][k.name] > 0 for k in (K.FR_SCAN, K.NTT, K.MSM_BUCKET_SUM,
                                                         K.MSM_WINDOW)),
               f"rank {r}: B6, K3 and K4's MSM stages launched")
    return ranks


def expect_launches(counts, ran, idle, path):
    for name in ran:
        expect(counts[name] > 0, f"kernel {name} launched {counts[name]} times on the {path}")
    for name in idle:
        expect(counts[name] == 0, f"kernel {name} not launched on the {path}")


@contextlib.contextmanager
def recording(K):
    """Record, inside the block, the distinct calls of K3 (grid shape, axis
    and tables), the batch sizes of the fixed-base op, and the widths of the
    batch inversions by power of two ({"Fq 2^k": calls of width in
    (2^(k-1), 2^k]}), as the entry points make them (`ops` and the kernel
    wrappers call all three through the module)."""
    calls = {"ntt": {}, "fixed_base": set(), "batch_inv": {}}
    fr_ntt, fixed_base, batch_inv = K.fr_ntt, K.g1_fixed_base, K.batch_inv

    def ntt(data, pows, scale=None, axis=2, inplace=False):
        key = (tuple(data.shape), axis, inplace) + tuple(
            None if t is None else t.data_ptr() for t in (pows, scale))
        calls["ntt"].setdefault(key, (tuple(data.shape), axis, inplace, pows, scale))
        return fr_ntt(data, pows, scale, axis, inplace)

    def fixed(scalars, table):
        calls["fixed_base"].add(int(scalars.shape[1]))
        return fixed_base(scalars, table)

    def binv(field, a):
        key = f"{'Fq' if field else 'Fr'} 2^{max(0, int(a.shape[1]) - 1).bit_length()}"
        calls["batch_inv"][key] = calls["batch_inv"].get(key, 0) + 1
        return batch_inv(field, a)

    K.fr_ntt, K.g1_fixed_base, K.batch_inv = ntt, fixed, binv
    try:
        yield calls
    finally:
        K.fr_ntt, K.g1_fixed_base, K.batch_inv = fr_ntt, fixed_base, batch_inv


def rand_fr(torch, shape, seed, dev):
    """Random reduced Fr limbs [16, *shape] made on the card."""
    from tokamak_zk_evm_tpu_torch.fields import FR

    g = torch.Generator(device=dev).manual_seed(seed)
    lim = torch.randint(0, 1 << 16, (16,) + tuple(shape), generator=g, device=dev,
                        dtype=torch.int32)
    lim[15] = torch.randint(0, FR.modulus >> 240, tuple(shape), generator=g, device=dev,
                            dtype=torch.int32)
    return lim


def check_ntt_calls(torch, K, dev, calls):
    """K3 against its plain version at every recorded call signature, on
    random grids of the recorded shapes."""
    for seed, (shape, axis, inplace, pows, scale) in enumerate(calls.values()):
        kind = "inverse" if scale is not None else "forward"
        data = rand_fr(torch, shape[1:], seed, dev)
        want = K.plain_ntt(data, pows, scale, axis)
        got = K.fr_ntt(data, pows, scale, axis, inplace)
        expect(torch.equal(got, want), f"K3 grid {list(shape[1:])} axis {axis} ({kind}"
               f"{', in place' if inplace else ''}): kernel == plain")
        del data, got, want
    torch.cuda.empty_cache()


def affine_msm_check(torch, np, K, dev, n=1 << 22):
    """One n-point MSM through the affine tree == Pippenger == oracle."""
    from tokamak_zk_evm_tpu_torch.ops import msm as TM

    k, px, py, pinf, want = oracle_inputs(torch, np, K, dev, np.random.default_rng(5), n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TM.use_core("affine_tree"):
        got = TM.msm(k, px, py, pinf)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    pip = TM.msm(k, px, py, pinf)
    pip_secs = time.perf_counter() - t0
    log(f"  {n}-point MSM: affine_tree {secs:.3f} s (peak {peak / 2**30:.3f} GiB), "
        f"pippenger {pip_secs:.3f} s")
    expect(got == want, f"affine_tree MSM of {n} points == (sum k_i c_i) G")
    expect(got == pip, f"affine_tree MSM of {n} points == pippenger")
    del k, px, py, pinf
    torch.cuda.empty_cache()
    return {"affine_tree_s": round(secs, 4), "affine_tree_peak_gib": round(peak / 2**30, 3),
            "pippenger_s": round(pip_secs, 4)}


# ---------------------------------------------------------------------------
# phase 6: timings and bounds
# ---------------------------------------------------------------------------

FR_MUL_OPS = 2 * (2 * 8 * 8 + 8)  # 32-bit CIOS multiply-adds, x2 ops each
FQ_MUL_OPS = 2 * (2 * 12 * 12 + 12)
MIXED_ADD_MULS = 11
JAC_ADD_MULS = 16
DBL_MULS = 7


def limbs_err(a, b) -> int:
    """Largest limb difference between two outputs (tensors or tuples of
    them; 0 = byte-equal)."""
    if isinstance(a, tuple):
        return max(limbs_err(x, y) for x, y in zip(a, b))
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


def packed_err(K, p, q) -> int:
    """`points_err` of two packed jacobian outputs ([n, 36] words)."""
    return points_err(K, K.unpack_points(p, 3), K.unpack_points(q, 3))


def msm_stage_inputs(torch, np, K, dev, rng, n, skew=False):
    """The level-1 bucket-sum and the window-reduce inputs of one MSM of n
    oracle points: {stage: (kernel fn, plain fn, bytes, ops, shape)}.
    Bytes: each input read once (packed points, entry indices, chunk
    bounds, bucket sums and keys), each output written once.  Operations:
    11 Fq products per mixed add of the first bucket-sum pass and 16 per
    jacobian add of the second, one add per entry but the first of a chunk,
    which is loaded (m - chunks adds; "per_entry_ops" counts m, as the
    earlier kernel's bound did); for the window reduce 16 per jacobian add, two adds per
    bucket (the running sum and the total), the least a running-sum
    reduction does."""
    k, px, py, pinf, want = oracle_inputs(torch, np, K, dev, rng, n, skew)
    c, nwin, pidx, bucket, cnt = K.msm_plan(k, pinf)
    pts = K.pack_points(px, py)
    start, length, per = K.chunk_segments(cnt)
    m, nch = int(pidx.shape[0]), int(start.shape[0])
    tag = f"2^{n.bit_length() - 1} points{' skewed' if skew else ''}"
    out = {"inputs": (k, px, py, pinf, want),
           "per_entry_ops": m * MIXED_ADD_MULS * FQ_MUL_OPS}
    out["bucket"] = (
        lambda: K.msm_bucket_sum(0, pts, pidx, start, length),
        lambda: K.plain_msm_bucket_sum(0, pts, pidx, start, length),
        96 * n + 8 * m + 16 * nch + 144 * nch,
        (m - nch) * MIXED_ADD_MULS * FQ_MUL_OPS,
        f"{tag}, {m} entries, {nch} chunks")
    # chunks are summed independently: every 64th, for a plain check of a
    # kernel run over all of them
    sel = torch.arange(0, nch, 64, device=dev)
    out["bucket_every_64th"] = (
        sel, lambda: K.plain_msm_bucket_sum(0, pts, pidx, start[sel], length[sel]))

    def second_pass(part):
        """The jacobian pass over the first pass's chunk partials `part`, as
        `segment_sums` runs it: (kernel fn, plain fn on every 64th chunk,
        selection, bytes, ops, shape)."""
        start2, length2, _ = K.chunk_segments(per)
        nch2 = int(start2.shape[0])
        sel2 = torch.arange(0, nch2, 64, device=dev)
        return (lambda: K.msm_bucket_sum(1, part, None, start2, length2),
                lambda: K.plain_msm_bucket_sum(1, part, None, start2[sel2], length2[sel2]),
                sel2, 144 * nch + 16 * nch2 + 144 * nch2,
                (nch - nch2) * JAC_ADD_MULS * FQ_MUL_OPS,
                f"{tag}, pass 2: {nch} partials, {nch2} chunks")

    out["bucket_pass2"] = second_pass
    nb = 1 << c
    sums = K.segment_sums(K.msm_bucket_sum, 0, pts, pidx, cnt)
    nbk = int(bucket.shape[0])
    out["window"] = (
        lambda: K.window_sums(K.msm_window_reduce, sums, bucket, nwin, nb),
        lambda: K.window_sums(K.plain_msm_window_reduce, sums, bucket, nwin, nb),
        (144 + 8) * nbk + 144 * nwin,
        2 * nwin * nb * JAC_ADD_MULS * FQ_MUL_OPS,
        f"{nwin} windows x 2^{c} buckets, all levels")
    seg = min(K.MSM_SEG, nb)
    out["window_level1"] = lambda: K.msm_window_reduce(sums, None, bucket, nwin * nb // seg,
                                                       seg, 0)
    # the other first-level segment that fills the card, timed beside the default
    out["window_seg8"] = lambda: K.window_sums(K.msm_window_reduce, sums, bucket, nwin, nb, 8, 2)
    return out


def divsteps_to_zero(x: int, p: int) -> int:
    """Divsteps of the Bernstein-Yang extended gcd of (p, x) (delta = 1 at
    the start) until g = 0; K2's inversion runs ceil(this / 30) batches."""
    d, f, g, n = 1, p, x, 0
    while g:
        if d > 0 and g & 1:
            d, f, g = 1 - d, g, (g - f) >> 1
        elif g & 1:
            d, g = 1 + d, (g + f) >> 1
        else:
            d, g = 1 + d, g >> 1
        n += 1
    return n


def inversion_ops(field: int, values) -> int:
    """Operations of K2's inversions of the nonzero `values` (the words it
    inverts, Montgomery form): per batch of 30 divsteps, 10 S 32 x 32 ->
    64-bit products on S = 9 (Fr) / 13 (Fq) limbs of 30 bits (6 S for
    (d, e), 4 S for (f, g)), two operations each; and one Montgomery product
    (R^3) an inversion."""
    from tokamak_zk_evm_tpu_torch.fields import Q_MOD, R_MOD

    p, S = ((R_MOD, 9), (Q_MOD, 13))[field]
    mul = (FR_MUL_OPS, FQ_MUL_OPS)[field]
    return sum(-(-divsteps_to_zero(v, p) // 30) * 2 * 10 * S + mul for v in values if v)


def column_values(spec, a) -> list[int]:
    host = a.cpu().numpy()
    return [spec.from_limbs(host[:, i].tolist()) for i in range(host.shape[1])]


def batch_total(K, field: int, a) -> int:
    """The product of a batch's nonzero elements, the value K2's batch
    inversion inverts (Montgomery form): a pairwise tree of plain products
    on the card."""
    import torch

    from tokamak_zk_evm_tpu_torch.fields import FQ, FR

    spec = (FR, FQ)[field]
    one = torch.tensor(spec.to_limbs(spec.R_mod), dtype=torch.int32, device=a.device)[:, None]
    x = torch.where((a == 0).all(0)[None, :], one, a)
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, one], 1)
        h = x.shape[1] // 2
        x = K.plain_field_ew(field, "mul", x[:, :h].contiguous(), x[:, h:].contiguous())
    return spec.from_limbs(x[:, 0].tolist())


def batch_inv_work(K, field: int, a) -> tuple[int, int]:
    """(bytes, operations) of one batch inversion of a [L, n] batch: read and
    written once; 3 (m - 1) Montgomery products over its m nonzero elements
    and the one inversion of their product."""
    L, n = a.shape
    m = int((a != 0).any(0).sum())
    ops = 3 * max(m - 1, 0) * (FR_MUL_OPS, FQ_MUL_OPS)[field]
    return 8 * L * n, ops + inversion_ops(field, [batch_total(K, field, a)])


def bound_ms(nbytes: float, ops: float, ops_per_s: float = PEAK_OPS_PER_S):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def fixed_base_adds(torch, K, sc, bits: int) -> int:
    """The mixed adds of the fixed-base op on canonical scalars [16, B] that
    cost products: one a nonzero `bits`-bit digit, but the first of each
    scalar, which lands on an accumulator at infinity and is a copy."""
    s = sc.long()
    s = torch.cat([s, torch.zeros_like(s[:1])])
    total, live = 0, torch.zeros_like(s[0], dtype=torch.bool)
    for w in range(K.fixed_base_windows(bits)):
        o = bits * w
        d = ((s[o // 16] | (s[o // 16 + 1] << 16)) >> (o % 16)) & ((1 << bits) - 1)
        total += int(d.ne(0).sum())
        live |= d.ne(0)
    return total - int(live.sum())


def ntt_products(n: int, transforms: int) -> int:
    """Fr products of `transforms` radix-2 transforms of n points: n / 2 a
    stage, but the first, whose twiddles are all one."""
    return transforms * (n // 2) * (n.bit_length() - 2)


def measure(torch, np, K, dev, counts, fixed_sizes):
    from tokamak_zk_evm_tpu_torch.fields import FQ, FR
    from tokamak_zk_evm_tpu_torch.host.curve import G1
    from tokamak_zk_evm_tpu_torch.ops import ntt as NT

    rng = np.random.default_rng(2)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    rows = []

    def row(kern, shape, fn, plain, nbytes, ops, reps=5, points=False):
        got, want = fn(), plain()
        if points:
            err = packed_err(K, got, want) if torch.is_tensor(got) else points_err(K, got, want)
        else:
            err = limbs_err(got, want)
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
    pms = cuda_ms(torch, lambda: K.plain_field_ew(0, "neg", a), 1)
    b_neg, _ = bound_ms(2 * 64 * n, 0)
    rows[-1].update({"neg_ms": round(ms, 4), "neg_plain_ms": round(pms, 4),
                     "neg_bound_ms": round(b_neg, 4)})
    log(f"  {'fr_ew':18s} {'Fr neg 2^23':28s} {ms:10.3f} ms  plain {pms:10.3f} ms  "
        f"bound {b_neg:8.4f} ms (bytes)")
    del a, b
    n = 1 << 22  # setup's xy_powers family to affine
    a, b = T(rand_field(np, rng, FQ, n)), T(rand_field(np, rng, FQ, n))
    row(K.FQ_EW, "Fq mul 2^22", lambda: K.fq_mul(a, b), lambda: K.plain_field_ew(1, "mul", a, b),
        3 * 96 * n, FQ_MUL_OPS * n)
    del a, b

    def extra(key, shape, fn, plain, nbytes, ops, reps):
        """Another shape of the last row's kernel: held against the plain
        version, timed beside it and its bounds, into the row as key_*."""
        box = {}
        got = fn()
        pms = cuda_ms(torch, lambda: box.__setitem__("want", plain()), 1, warm=False)
        err = limbs_err(got, box.pop("want"))
        del got
        expect(err == 0, f"{rows[-1]['name']} {shape}: kernel == plain (max_abs_err {err})")
        ms = cuda_ms(torch, fn, reps)
        b, by = bound_ms(nbytes, ops)
        rows[-1].update({f"{key}_shape": shape, f"{key}_ms": round(ms, 4),
                         f"{key}_plain_ms": round(pms, 4), f"{key}_max_abs_err": err,
                         f"{key}_bound_ms": round(b, 6), f"{key}_bound_by": by,
                         f"{key}_imad_bound_ms": round(bound_ms(nbytes, ops, IMAD_PER_S)[0], 6)})
        log(f"  {rows[-1]['name']:18s} {shape:28s} {ms:10.4f} ms  plain {pms:10.3f} ms  "
            f"bound {b:8.6f} ms ({by})")

    # K2.  The per-element inversion (batches up to BINV_EACH, and the tile
    # totals of wider ones) at 4096 Fr, then Fq 4096 and both at 1; bound:
    # the batch read and written once, and the gcd batches these inputs take.  The batch inversion at prove1's
    # grand-product denominators (m_i * s_max = 2^20 Fr), then in Fq at the
    # affine tree's widest level and setup's xy_powers family (2^22), at
    # 2^10, and at 1 (the latency of every call); bound: the batch read and
    # written once, 3 (n - 1) products and one inversion.
    n = 4096
    a = T(rand_field(np, rng, FR, n))
    row(K.FIELD_INV, "Fr inverse 4096", lambda: K.field_inv(0, a),
        lambda: K.plain_field_inv(0, a), 2 * 64 * n, inversion_ops(0, column_values(FR, a)))
    for field, spec, n in ((1, FQ, 4096), (0, FR, 1), (1, FQ, 1)):
        a = T(inversion_batch(np, rng, spec, n))
        extra(f"{spec.name.lower()}_{n}", f"{spec.name} inverse {n}",
              lambda: K.field_inv(field, a), lambda: K.plain_field_inv(field, a),
              8 * spec.n_limbs * n, inversion_ops(field, column_values(spec, a)), 20)
    n = 1 << 20
    a = T(rand_field(np, rng, FR, n))
    row(K.BATCH_INV, "Fr batch inverse 2^20", lambda: K.batch_inv(0, a),
        lambda: K.plain_batch_inv(0, a), *batch_inv_work(K, 0, a))
    for n, reps in ((1 << 22, 5), (1 << 10, 50), (1, 50)):
        a = T(inversion_batch(np, rng, FQ, n))
        extra(f"fq_2^{n.bit_length() - 1}", f"Fq batch inverse 2^{n.bit_length() - 1}",
              lambda: K.batch_inv(1, a), lambda: K.plain_batch_inv(1, a),
              *batch_inv_work(K, 1, a), reps)
    del a
    torch.cuda.empty_cache()
    # B6 at round 1's suffix product (m_i * s_max = 2^20 Fr), then the
    # prefix scan; bound: the array read and written once, and two products
    # an element (a work-efficient scan's count); beside the K1 doubling
    # chain it replaced (`utils/bench_scan.py`)
    from tokamak_zk_evm_tpu_torch.utils.bench_scan import k1_chain

    n = 1 << 20
    a = rand_fr(torch, (n,), 21, dev)
    scan_bytes, scan_ops = 2 * 64 * n, 2 * (n - 1) * FR_MUL_OPS
    row(K.FR_SCAN, "Fr suffix scan 2^20", lambda: K.fr_scan(a, True),
        lambda: K.plain_fr_scan(a, True), scan_bytes, scan_ops)
    extra("prefix", "Fr prefix scan 2^20", lambda: K.fr_scan(a), lambda: K.plain_fr_scan(a),
          scan_bytes, scan_ops, 5)
    ms = cuda_ms(torch, lambda: k1_chain(K, a, True), 3)
    rows[-1]["k1_chain_ms"] = round(ms, 4)
    log(f"  {'fr_scan':18s} {'K1 chain, suffix 2^20':28s} {ms:10.3f} ms (the route it replaced)")
    del a
    torch.cuda.empty_cache()
    # prove2's largest bivariate grid, [16, 16384, 512]: its X pass (axis 1,
    # n = 16384, two passes), its Y pass (axis 2, n = 512, one), and the same
    # 16384-point rows laid along axis 2 ([16, 512, 16384]).  Bound: the grid
    # read once and written once, one product a butterfly but on the first
    # stage (the forward transform applies no scale; the two-pass kernel
    # does n / 2 more a transform, its four-step twiddles).
    nn, batch = 16384, 512
    grid = rand_fr(torch, (nn, batch), 11, dev)
    tables = NT._tables(nn, False, dev)
    grid_bytes = 2 * 64 * nn * batch
    bf = ntt_products(nn, batch)
    row(K.NTT, "16384 x 512, axis 1 (n=16384)", lambda: K.fr_ntt(grid, *tables, axis=1),
        lambda: K.plain_ntt(grid, *tables, axis=1), grid_bytes, bf * FR_MUL_OPS)
    rows_t = grid.transpose(1, 2).contiguous()
    y_tables = NT._tables(batch, False, dev)
    for key, shape, fn, plain, ops in (
            ("axis2_n512", "16384 x 512, axis 2 (n=512)",
             lambda: K.fr_ntt(grid, *y_tables, axis=2),
             lambda: K.plain_ntt(grid, *y_tables, axis=2), ntt_products(batch, nn)),
            ("axis2_n16384", "512 x 16384, axis 2 (n=16384)",
             lambda: K.fr_ntt(rows_t, *tables, axis=2),
             lambda: K.plain_ntt(rows_t, *tables, axis=2), bf)):
        err = limbs_err(fn(), plain())
        expect(err == 0, f"ntt {shape}: kernel == plain (max_abs_err {err})")
        ms = cuda_ms(torch, fn)
        b, by = bound_ms(grid_bytes, ops * FR_MUL_OPS)
        rows[-1].update({f"{key}_shape": shape, f"{key}_ms": round(ms, 4),
                         f"{key}_max_abs_err": err, f"{key}_bound_ms": round(b, 4),
                         f"{key}_imad_bound_ms": round(
                             bound_ms(grid_bytes, ops * FR_MUL_OPS, IMAD_PER_S)[0], 4)})
        log(f"  {K.NTT.name:18s} {shape:28s} {ms:10.3f} ms  bound {b:8.4f} ms ({by})")
    del grid, rows_t
    # past the two passes: a 2^23-point row through the four-step split
    # (two K3 calls, the twiddles gathered and multiplied by K1, two
    # transposes); bound: the row read and written once and the products of
    # one radix-2 transform
    n = 1 << 23
    long = rand_fr(torch, (1, n), 23, dev)
    pows, _ = long_ntt_tables(torch, K, n, False, dev)
    err = limbs_err(K.fr_ntt(long, pows, axis=2), K.plain_ntt(long, pows, axis=2))
    expect(err == 0, f"ntt 1 x 2^23 (split): kernel == plain (max_abs_err {err})")
    ms = cuda_ms(torch, lambda: K.fr_ntt(long, pows, axis=2), 3)
    nbytes, ops = 2 * 64 * n, ntt_products(n, 1) * FR_MUL_OPS
    b, by = bound_ms(nbytes, ops)
    rows[-1].update({"split_shape": "1 x 2^23, axis 2 (n=2^23, four-step split)",
                     "split_ms": round(ms, 4), "split_max_abs_err": err,
                     "split_bound_ms": round(b, 4), "split_bound_by": by,
                     "split_imad_bound_ms": round(bound_ms(nbytes, ops, IMAD_PER_S)[0], 4)})
    log(f"  {K.NTT.name:18s} {'1 x 2^23 (split)':28s} {ms:10.3f} ms  bound {b:8.4f} ms ({by})")
    del long, pows
    torch.cuda.empty_cache()
    # The fixed-base op at setup's largest family (xy_powers, 8192 x 512 =
    # 2^22 scalars) on the 12-bit table, held against the plain version on
    # the 8-bit one; then at the other sizes setup gave it (phase 5), and the
    # 12-bit table's build on the card.  Bound: scalars read, three
    # coordinates written and the table read once; one mixed add (11
    # products) a nonzero 12-bit digit but the first of each scalar (8-bit
    # digits: bound_ms_8bit).
    table = K.fixed_base_table(*G1.gen, dev)
    table8 = K.fixed_base_table(*G1.gen, dev, 8)
    build_ms = cuda_ms(torch, lambda: K._fixed_base_table_packed.__wrapped__(
        *G1.gen, K.FIXED_BASE_BITS, dev.type), 3)  # on the card, then to the host
    copy_ms = cuda_ms(torch, lambda: K.fixed_base_table(*G1.gen, dev), 3)  # to the card
    n = 1 << 22
    sc = rand_fr(torch, (n,), 12, dev)

    def fixed_bounds(B):
        nbytes = 64 * B + 3 * 96 * B + 96 * table.shape[0]
        ops12 = fixed_base_adds(torch, K, sc[:, :B], 12) * MIXED_ADD_MULS * FQ_MUL_OPS
        ops8 = fixed_base_adds(torch, K, sc[:, :B], 8) * MIXED_ADD_MULS * FQ_MUL_OPS
        return nbytes, ops12, ops8

    nbytes, ops12, ops8 = fixed_bounds(n)
    row(K.G1_FIXED_BASE, "2^22 scalars", lambda: K.g1_fixed_base(sc, table),
        lambda: K.plain_g1_fixed_base(sc, table8, 8), nbytes, ops12, reps=3, points=True)
    rows[-1].update({"bound_ms_8bit": round(bound_ms(nbytes, ops8)[0], 4),
                     "imad_bound_ms_8bit": round(bound_ms(nbytes, ops8, IMAD_PER_S)[0], 4),
                     "window_bits": K.FIXED_BASE_BITS, "table_build_ms": round(build_ms, 4),
                     "table_copy_ms": round(copy_ms, 4)})
    log(f"  {'':18s} 12-bit table build {build_ms:.3f} ms, copy to the card {copy_ms:.3f} ms; "
        f"8-bit bound {rows[-1]['bound_ms_8bit']:.4f} ms")
    by_size = {}
    for B in fixed_sizes:
        if B == n or B > n:
            continue
        part = sc[:, :B].contiguous()
        ms = cuda_ms(torch, lambda: K.g1_fixed_base(part, table), 3)
        nb, o12, o8 = fixed_bounds(B)
        by_size[B] = {"ms": round(ms, 4), "bound_ms": round(bound_ms(nb, o12)[0], 4),
                      "imad_bound_ms": round(bound_ms(nb, o12, IMAD_PER_S)[0], 4),
                      "bound_ms_8bit": round(bound_ms(nb, o8)[0], 4),
                      "imad_bound_ms_8bit": round(bound_ms(nb, o8, IMAD_PER_S)[0], 4)}
        log(f"  {K.G1_FIXED_BASE.name:18s} {f'{B} scalars':28s} {ms:10.3f} ms  "
            f"bound {by_size[B]['bound_ms']:8.4f} ms (operations)")
    rows[-1]["setup_family_sizes"] = by_size
    del sc, table8
    torch.cuda.empty_cache()
    # The MSM stages at the main path's largest commitment, 2^22 points. The
    # plain bucket sum over all of its chunks would gather 2^26 points
    # (~40 GB of int64 limbs), so there it is held against every 64th chunk
    # of the kernel's output, and timed in full at 2^16 points. The same at
    # 2^22 for skewed (witness-like) scalars, whose MSM is also held against
    # the oracle.
    main = {}

    def every_64th(key, fn, sel, plain_sel, nbytes, ops, shape):
        """Run a bucket-sum pass over all chunks, hold every 64th chunk to the
        plain version, time it; -> the kernel's output."""
        got = fn()
        err = points_err(K, K.unpack_points(got[sel], 3), K.unpack_points(plain_sel(), 3))
        expect(err == 0, f"msm_bucket_sum {shape}: kernel == plain on every 64th chunk "
               f"({sel.shape[0]} chunks, max_abs_err {err})")
        ms = cuda_ms(torch, fn, 3)
        b, by = bound_ms(nbytes, ops)
        log(f"  {K.MSM_BUCKET_SUM.name:18s} {shape:28s} {ms:10.3f} ms  (kernel only)  "
            f"bound {b:8.4f} ms ({by})")
        main.update({key + "shape": shape, key + "ms": round(ms, 4),
                     key + "bound_ms": round(b, 4), key + "max_abs_err": err,
                     key + "imad_bound_ms": round(bound_ms(nbytes, ops, IMAD_PER_S)[0], 4)})
        return got

    for skew in (False, True):
        big = msm_stage_inputs(torch, np, K, dev, rng, 1 << 22, skew)
        fn, _, nbytes, ops, shape = big["bucket"]
        key = "skewed_" if skew else "main_path_"
        part = every_64th(key, fn, *big["bucket_every_64th"], nbytes, ops, shape)
        main[key + "bound_ms_per_entry"] = round(bound_ms(nbytes, big["per_entry_ops"])[0], 4)
        fn2, plain2, sel2, nbytes2, ops2, shape2 = big["bucket_pass2"](part)
        every_64th(key + "pass2_", fn2, sel2, plain2, nbytes2, ops2, shape2)
        del part, fn2, plain2
        k, px, py, pinf, want = big["inputs"]
        if skew:
            got = rows_affine(K.g1_msm(k, px, py, pinf))
            expect(got == want, "skewed MSM of 2^22 points == (sum k_i c_i) G")
            main["skewed_g1_msm_start_ms"] = round(
                cuda_ms(torch, lambda: K.g1_msm_start(k, px, py, pinf), reps=2), 4)
            del big
            break
        fn, plain, nbytes, ops, shape = big["window"]
        window_args = (K.MSM_WINDOW, shape, fn, plain, nbytes, ops)
        err = packed_err(K, big["window_seg8"](), fn())
        expect(err == 0, f"window reduce 8/2 == {K.MSM_SEG}/{K.MSM_SEG_UP} (max_abs_err {err})")
        seg8_ms = cuda_ms(torch, big["window_seg8"], 3)
        level1_ms = cuda_ms(torch, big["window_level1"], 3)
        msm_ms = cuda_ms(torch, lambda: K.g1_msm_start(k, px, py, pinf), reps=2)
        log(f"  g1_msm_start (plan + K4 stages) at 2^22 points: {msm_ms:.3f} ms")
        del big, k, px, py, pinf
        torch.cuda.empty_cache()
    small = msm_stage_inputs(torch, np, K, dev, rng, 1 << 16)
    fn_s, plain_s, nbytes_s, ops_s, shape_s = small["bucket"]
    row(K.MSM_BUCKET_SUM, shape_s, fn_s, plain_s, nbytes_s, ops_s, points=True)
    rows[-1]["bound_ms_per_entry"] = round(bound_ms(nbytes_s, small["per_entry_ops"])[0], 4)
    rows[-1].update(main)
    del small
    row(*window_args, reps=3, points=True)
    rows[-1].update({"level1_ms": round(level1_ms, 4), "seg_8_2_ms": round(seg8_ms, 4),
                     "g1_msm_start_2^22_ms": round(msm_ms, 4)})
    log(f"  {K.MSM_WINDOW.name:18s} level 1 alone {level1_ms:10.3f} ms, "
        f"all levels at 8/2 {seg8_ms:10.3f} ms")
    torch.cuda.empty_cache()
    # K5 at the affine tree's widest merge level at 2^22 points (wb = 2
    # windows of 2^21 pairs), every lane a P+Q add: aff_post does its three
    # products on every lane, the most it does for any lane but a doubling
    n = 1 << 22
    x1, y1, x2, y2 = planted_affine(torch, np, K, dev, rng, n, "add")
    shape = "2^22 lanes, P+Q"
    row(K.AFF_PRE, shape, lambda: K.aff_pre(x1, y1, x2, y2),
        lambda: K.plain_aff_pre(x1, y1, x2, y2), 5 * 96 * n, 0)
    dinv = K.fq_batch_inv(K.aff_pre(x1, y1, x2, y2))
    row(K.AFF_POST, shape, lambda: K.aff_post(x1, y1, x2, y2, dinv),
        lambda: K.plain_aff_post(x1, y1, x2, y2, dinv), 7 * 96 * n, 3 * FQ_MUL_OPS * n)
    ms = cuda_ms(torch, lambda: K.g1_aff_add_batch((x1, y1), (x2, y2)), 3)
    # bound of the whole add: four coordinates read and two written; 3 (n - 1)
    # products and one inversion for the denominators, three products a lane
    ops = (6 * n - 3) * FQ_MUL_OPS + inversion_ops(1, [batch_total(K, 1, dinv)])
    b, by = bound_ms(6 * 96 * n, ops)
    rows[-1].update({"g1_aff_add_batch_ms": round(ms, 4),
                     "g1_aff_add_batch_bound_ms": round(b, 4),
                     "g1_aff_add_batch_bound_by": by,
                     "g1_aff_add_batch_imad_bound_ms": round(
                         bound_ms(6 * 96 * n, ops, IMAD_PER_S)[0], 4)})
    log(f"  g1_aff_add_batch (aff_pre + Fq batch inverse + aff_post) {shape}: {ms:.3f} ms  "
        f"bound {b:.4f} ms ({by})")
    # B13 at 2^22 lanes (the ceremony's widest multiplications, xy_powers
    # and delta_inv_li_o_prv, hold 4.2M lanes), on the same P+Q pairs
    # doubled (Z != 1).  Bounds: each coordinate read and written once; 16
    # products an add and 7 a doubling (every lane takes the generic
    # formula), 4 for the affine pass (Z^-1 read beside the point, inf
    # written).
    one = K._FQ.one(dev).expand(K.FQ_L, n).to(torch.int32).contiguous()
    P, Q = K.g1_dbl((x1, y1, one)), K.g1_dbl((x2, y2, one))
    del dinv, x1, y1, x2, y2, one
    torch.cuda.empty_cache()
    row(K.G1_ADD, shape, lambda: K.g1_add(P, Q), lambda: K.plain_g1_add(P, Q),
        9 * 96 * n, JAC_ADD_MULS * FQ_MUL_OPS * n, reps=5)
    row(K.G1_DBL, "2^22 lanes", lambda: K.g1_dbl(P), lambda: K.plain_g1_dbl(P),
        6 * 96 * n, DBL_MULS * FQ_MUL_OPS * n, reps=5)
    zi = K.fq_batch_inv(P[2])
    row(K.G1_TO_AFFINE, "2^22 lanes (after K2)", lambda: K.g1_affine_scale(P, zi),
        lambda: K.plain_g1_affine_scale(P, zi), (6 * 96 + 4) * n, 4 * FQ_MUL_OPS * n, reps=5)
    ms = cuda_ms(torch, lambda: K.g1_to_affine(P), 3)
    rows[-1]["with_batch_inv_ms"] = round(ms, 4)
    log(f"  g1_to_affine (Fq batch inverse + affine kernel) 2^22 lanes: {ms:.3f} ms")
    del P, Q, zi
    torch.cuda.empty_cache()
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
                if any(w in line for w in ("Function properties", "stack frame", "registers")):
                    log(f"    {name}: {line.strip()}")
    for name, kerns in PTXAS_CLEAN.items():
        frames = ptxas_frames(os.path.join(build.BUILD_DIR, f"{name}.log"))
        for kern in kerns:
            found = [fn for fn in frames if kern in fn]
            expect(len(found) == 1, f"ptxas: {name}.log reports {kern} once ({len(found)} found)")
            frame = frames[found[0]]
            expect(frame == (0, 0, 0), f"ptxas: {kern} has no stack frame and no spills {frame}")
        expect(len(frames) == len(kerns), f"ptxas: {name}.log reports exactly {list(kerns)} "
               f"({len(frames)} functions found)")

    check_kernels(torch, np, K, dev)
    check_curve_ops(torch, np, K, dev)
    check_affine(torch, np, K, dev)

    log("[4] golden toy proof on the card")
    t0 = time.perf_counter()
    prove_toy(np, dev)
    log(f"    {time.perf_counter() - t0:.3f} s")

    log("[5] main path: synthetic full shape on the card, MSM core pippenger")
    fx = synthetic_fixture()
    with recording(K) as calls:
        sigma, proof, counts = drive(torch, np, K, dev, fx, "pippenger")
    affine = [K.AFF_PRE.name, K.AFF_POST.name]
    b13 = [K.G1_ADD.name, K.G1_DBL.name, K.G1_TO_AFFINE.name]
    # the ceremony's: setup and prove add no jacobian points on the card, and
    # setup's Fq products were its to-affine steps, now B13's affine kernel
    not_needed = b13[:2] + [K.FQ_EW.name]
    expect_launches(counts, [n for n in counts if n not in affine + not_needed], affine,
                    "pippenger path")
    log("  batch inversions by width: " + json.dumps(calls["batch_inv"]))
    log(f"[5c] K3 at each of the {len(calls['ntt'])} call signatures of phase 5 "
        f"(grid, axis, tables): kernel == plain, exact")
    check_ntt_calls(torch, K, dev, calls["ntt"])

    log("[5b] MSM core affine_tree: a 2^22-point MSM, then the main path again")
    msm_stats = affine_msm_check(torch, np, K, dev)
    with recording(K) as calls_b:
        _, proof_b, counts_b = drive(torch, np, K, dev, fx, "affine_tree", sigma)
    log("  batch inversions by width: " + json.dumps(calls_b["batch_inv"]))
    expect(proof_b == proof, "affine_tree proof bytes == pippenger proof bytes")
    expect_launches(counts_b, affine + [K.FIELD_INV.name, K.BATCH_INV.name, K.FR_SCAN.name],
                    [K.MSM_BUCKET_SUM.name, K.MSM_WINDOW.name], "affine_tree path")

    log("[5d] the file-contract path: the port's CLI, setup -> preprocess -> prove -> verify "
        f"through files at the synthetic full shape ({gpu_line()})")
    counts_d, _, proof_zero = drive_files(torch, np, K, dev, fx, sigma)
    expect_launches(counts_d, [n for n in counts_d if n not in affine + not_needed], affine,
                    "file-contract path (5d)")
    del sigma
    torch.cuda.empty_cache()

    log("[5e] the MPC ceremony at the synthetic full shape: in process (seeded), then the "
        f"CLI's mpc steps through files ({gpu_line()})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    t_e = drive_ceremony(torch, np, dev, fx)
    t_e.update(drive_ceremony_files(torch, dev, fx))
    counts_e = K.counts()
    peak_e = torch.cuda.max_memory_allocated()
    log("  seconds: " + json.dumps({k: round(v, 3) for k, v in t_e.items()}))
    log("  kernels " + json.dumps(counts_e))
    log(f"  peak device memory {peak_e / 2**30:.3f} GiB")
    expect_launches(counts_e, b13 + [K.FR_EW.name, K.FQ_EW.name, K.FIELD_INV.name,
                                     K.BATCH_INV.name, K.MSM_BUCKET_SUM.name, K.MSM_WINDOW.name],
                    [], "ceremony path (5e)")

    log(f"[5f] the multi-device path ({gpu_line()}): (i) one rank over NCCL")
    t0 = time.perf_counter()
    nccl_stats = drive_nccl_one(torch, np, K, dev)
    log(f"  (i) {time.perf_counter() - t0:.3f} s")
    log("[5f] (ii) two ranks sharing the card over gloo prove the synthetic full shape")
    ranks_f = drive_gloo_two(torch, K, proof_zero)
    del proof_zero

    log("[6] kernel times (CUDA events) beside plain versions and bounds")
    counts_5 = dict(counts)
    counts.update({n: counts_b[n] for n in affine})
    counts.update({n: counts_e[n] for n in b13})  # B13's path is the ceremony
    rows = measure(torch, np, K, dev, counts, sorted(calls["fixed_base"]))
    next(r for r in rows if r["name"] == K.AFF_POST.name)["affine_tree_msm_2^22"] = msm_stats
    binv_row = next(r for r in rows if r["name"] == K.BATCH_INV.name)
    for kern in (K.FIELD_INV, K.BATCH_INV, K.FR_SCAN, K.G1_TO_AFFINE):
        next(r for r in rows if r["name"] == kern.name)["launches_5b"] = counts_b[kern.name]
    for r in rows:
        r["launches_5d"] = counts_d[r["name"]]
        r["launches_5e"] = counts_e[r["name"]]
        r["launches_5f"] = [res["kernels"][r["name"]] for res in ranks_f]
        if r["name"] in b13:
            r["launches_5"] = counts_5[r["name"]]
    binv_row["widths_5"] = calls["batch_inv"]
    next(r for r in rows if r["name"] == K.NTT.name)["nccl_one_rank_5f"] = nccl_stats
    binv_row["widths_5b"] = calls_b["batch_inv"]
    kernels_line = json.dumps({"kernels": rows})

    log(f"total {time.perf_counter() - t_all:.3f} s")
    print(gpu_line())
    print(kernels_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
