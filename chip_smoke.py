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
     kernel, the G1 ops build B13's three (add, doubling, to-affine) and
     the four probes of `utils/bench_g1.py`, the inversion build its six
     (three a field), the scan build B6's one (`scan_kernel`: one pass,
     a decoupled look-back) and the CRS decode build its one
     (`crs_decode_kernel`), each with no stack frame and no spills;
  3. each kernel against its plain PyTorch version on the card, exact:
     K1 on Fr and Fq batches holding 0, 1 and p-1; K2's inversion at 1 and
     4096 elements and its batch inversion at 1, 2, its one-launch width
     +-1, a tile past it, 2^20 (Fr) and 2^22 (Fq), with zeros at tile and
     warp edges, and on all-zero batches, each also against host inverses
     (`pow`) on a sample, a * a^-1 == 1, and one launch or three; B6's
     prefix and suffix scans at 1, 2, a tile +-1, two tiles + 1, a group of
     32 tiles + 1, 2^20 and past a look-back window of 32 groups, without
     zeros and with zeros at thread, warp, tile and group edges, on zeros
     alone, and called back to back (a width three times, then a smaller
     and a larger one), one launch each; K3
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
     m_i=4096): generate_sigma -> Prover.prove() -> preprocess ->
     verify_snark(), with every kernel's
     launch counter set to 0 just before and read just after; every kernel
     of that path (B6's scan included) must have launched, and K5 not at
     all.  The run records
     each distinct call of K3 (grid, axis, tables), the fixed-base op's
     batch sizes and the widths of the batch inversions;
  5c. K3 against its plain version at every call signature phase 5
     recorded, on random grids of those shapes, exact;
  5d. the file-contract path: `build_synthetic()` staged as reference-layout
     files (library dir, the synthesizer's three JSONs), then the port's CLI
     (`cli.main`, in this process, counters set to 0 before and read after):
     setup --fixed-tau --format both, preprocess, prove --deterministic,
     verify; both CRS formats must load to phase 5's sigma, proof.json must
     be the in-process Mixer.zero() proof and hash to the JAX package's
     pinned digest, verify must print true and, for a proof with one limb
     changed, false; every kernel of the path but K5 must launch (the CRS
     decode among them: the CLI reads combined_sigma.rkyv); `python -m
     tokamak_zk_evm_tpu_torch doctor` must pass;
  5g. the frontend's witness path into the file contract, right after 5d in
     its directory: 5d's library read back with `load_library`, every one of
     the 256 placements re-derived from its inputs alone, (i) through
     `SubcircuitCalculators` (the library has no wasm/ dir, so every
     subcircuit must compile under `frontend/r1cs_eval`) and (ii) through
     `WitnessGenerator`'s solver engine and its R1CS check, each witness
     equal to the fixture's; the compiled schedule's placements written as
     placementVariables.json beside 5d's instance and permutation, then the
     CLI's prove --deterministic and verify on 5d's CRS (counters set to 0
     before, read after): proof.json must equal 5d's byte for byte and hash
     to the pinned digest, verify must print true, K1, K2, K3, K4's MSM
     stages and B6 must launch and K5 must not; the host seconds of each
     step are printed beside the card's name and power limit;
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
     read after: B13's kernels, K1, K2 and K4's MSM stages must launch.
     Every B13 add and doubling of the phase is recorded: its lane width
     (calls and lane-launches by power of two) and its device time (two
     CUDA events around each launch), beside the IMAD bound; and B13's
     device seconds in each step, beside the step's wall time.  Each op's
     recorded calls must equal its launch counter and its timed launches.
     The ceremony runs through `tokamak_zk_evm_tpu_torch/utils/
     ceremony_drive.py`;
  5f. the multi-device path (`parallel/`; the card machine has one GPU, and
     NCCL refuses two ranks on one card): (i) the scaling report
     (`SCALE_MSM_LOG2=22 python -m tokamak_zk_evm_tpu_torch.utils.scaling_report`,
     one NCCL rank), in which `bintt_dist` at 16384 x 512 must equal `bintt`
     and its inverse give the grid back, and `msm_dist` at 2^22 points and
     the unsharded MSM the O(1) oracle, each timed (one rank: cost figures,
     not scaling ones); its rows are printed; (ii) two spawned
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
     doubling and to-affine at 2^22 lanes; the CRS decode at 2^22 entries
     (infinities, a zero x and an all-ones entry planted);
  7. the bench (`python -m tokamak_zk_evm_tpu_torch.bench`, a subprocess,
     after this process has freed what it held on the card): its default
     ladder small -> mid -> full with TOKAMAK_BENCH_VERIFY=1 and a cache of
     its own; each rung must bank a line with `bench.py`'s five keys naming
     the card, its proof verified; the full rung's timed prove must launch
     K1, K2, K3, K4's MSM stages and B6 and not K5 (its counts are each
     kernel row's `launches_7`), its proof must hash to the pinned digest,
     its 2^22-point MSM probe must meet the O(1) oracle and its mesh table
     must be 5f's report.
The last lines are the bench's three JSON lines, the nvidia-smi line, the
kernels JSON and the device JSON. The port imports nothing of JAX; neither
does this script.
"""

from __future__ import annotations

import contextlib
import gc
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
    "g1_ops": ("g1_add_kernel", "g1_dbl_kernel", "g1_affine_kernel", "g1_probe_io_add",
               "g1_probe_io_dbl", "g1_probe_math_add", "g1_probe_math_dbl"),
    "field_inv": tuple(f"{k}_{f}" for k in ("inv_kernel", "binv_up", "binv_down")
                       for f in ("fr", "fq")),
    "fr_scan": ("scan_kernel",),
    "crs_decode": ("crs_decode_kernel",),
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
    """B6 against its plain version, prefix and suffix, exact, one launch a
    call: at widths on both sides of one tile, past a group of 32 tiles and
    past a look-back window of 32 groups, without zeros, with zeros at
    thread (K positions), warp (32 K), tile and group edges in the second
    half of the scan order, on zeros alone, and called back to back (the
    same width three times, then a smaller and a larger one: no call may
    read another's status records)."""
    from tokamak_zk_evm_tpu_torch.backend import build

    tile, per, group = K.SCAN_TILE, K.SCAN_K, K.SCAN_GROUP * K.SCAN_TILE
    expect(build.lib("fr_scan").tzk_fr_scan_tile() == tile,
           f"fr_scan.cu's tile == kernels.SCAN_TILE ({tile})")
    log("[3] B6 fr_scan: kernel == plain, exact, one launch a call")

    def edges(n, reverse):
        return [e for b in range(0, n, tile)
                for e in (b + per - 1, b + per, b + 32 * per - 1, b + 32 * per, b + tile - 1)
                + ((b - 1, b) if b % group == 0 else ())
                if 0 <= e < n and (e >= n // 2) != reverse]

    def check(a, reverse, what):
        before = K.FR_SCAN.launches
        got = K.fr_scan(a, reverse)
        launches = K.FR_SCAN.launches - before
        expect(torch.equal(got, K.plain_fr_scan(a, reverse)) and launches == 1,
               f"{'suffix' if reverse else 'prefix'} scan of {a.shape[1]} ({what}) == plain, "
               f"{launches} launch(es)")

    for n in (1, 2, tile - 1, tile, tile + 1, 2 * tile + 1, group + 1, 1 << 20,
              33 * group + 5):
        base = rand_fr(torch, (n,), 40 + n % 97, dev)
        for reverse in (False, True):
            zeroed = base.clone()
            zeroed[:, edges(n, reverse)] = 0
            check(base, reverse, "no zeros")
            check(zeroed, reverse, f"{len(edges(n, reverse))} zeros at edges")
        del base, zeroed
    widths = (40 * tile + 3,) * 3 + (tile + 1, 70 * group + 9)
    calls = [(n, i % 2 == 1) for i, n in enumerate(widths)]
    ins = [rand_fr(torch, (n,), 60 + i, dev) for i, (n, _) in enumerate(calls)]
    before = K.FR_SCAN.launches
    outs = [K.fr_scan(a, reverse) for a, (_, reverse) in zip(ins, calls)]
    launches = K.FR_SCAN.launches - before
    for i, (a, got, (n, reverse)) in enumerate(zip(ins, outs, calls)):
        expect(torch.equal(got, K.plain_fr_scan(a, reverse)),
               f"back-to-back call {i + 1} of {len(calls)} ({'suffix' if reverse else 'prefix'}, "
               f"{n}) == plain")
    expect(launches == len(calls), f"{len(calls)} back-to-back calls, {launches} launches")
    del ins, outs
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


def drive(torch, np, K, dev, fx):
    """The main path: setup, Prover init, prove, preprocess, verify; every
    launch counter set to 0 just before and read just after.
    -> (sigma, counts)."""
    from tokamak_zk_evm_tpu_torch.models.preprocess import preprocess
    from tokamak_zk_evm_tpu_torch.models.protocol import Mixer
    from tokamak_zk_evm_tpu_torch.models.prover import Prover
    from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
    from tokamak_zk_evm_tpu_torch.models.verifier import Verifier
    from tokamak_zk_evm_tpu_torch.utils import timing

    p = fx.params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    t = {}
    with timing.tracing():
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
    expect(ok is True, "full-shape proof verifies (port Verifier)")
    del prover, pre
    torch.cuda.empty_cache()
    return sigma, counts


# phase 5d's staged directories, under one scratch directory
STAGED = ("library", "synthesizer", "crs", "pre", "proof")


def run_cli(cli, dev, argv):
    """(exit code, last stdout line) of one call of the port's CLI."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--device", str(dev)] + argv)
    lines = out.getvalue().strip().splitlines()
    return rc, lines[-1] if lines else ""


def drive_files(torch, np, K, dev, fx, sigma, tmp):
    """Phase 5d: the synthetic full shape staged as reference-layout files
    (library dir, the synthesizer's three JSONs) in the scratch directory
    `tmp`, then the port's CLI in this process:
    setup --fixed-tau --format both, preprocess, prove --deterministic,
    verify; every launch counter set to 0 just before and read just after.
    Then: both CRS formats load to phase 5's `sigma`, proof.json is the
    in-process Mixer.zero() proof on that `sigma` and hashes to the JAX
    package's pinned digest, a proof with one limb changed prints false,
    and `python -m tokamak_zk_evm_tpu_torch doctor` passes.  The files stay
    in `tmp` for phase 5g.  -> (counts, seconds, the Mixer.zero() proof's
    canonical bytes)."""
    from tokamak_zk_evm_tpu_torch import cli
    from tokamak_zk_evm_tpu_torch.io import artifacts as art, crs, rkyv_crs
    from tokamak_zk_evm_tpu_torch.models.protocol import Mixer
    from tokamak_zk_evm_tpu_torch.models.prover import Prover
    from tokamak_zk_evm_tpu_torch.testing.synthetic import FULLSHAPE_PROOF_SHA256
    from tokamak_zk_evm_tpu_torch.utils.ceremony_drive import sigma_equal

    lib, synth, crs_dir, pre, prf = (os.path.join(tmp, d) for d in STAGED)
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
        rcs[name] = run_cli(cli, dev, argv)
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
    rc, out = run_cli(cli, dev, ["verify", "--crs", crs_dir, "--library", lib, "--preprocess",
                                 pre, "--proof", bad_dir, "--synthesizer", synth])
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
    torch.cuda.empty_cache()
    return counts, t, art.canonical_proof_bytes(proof)


def drive_frontend(torch, K, dev, fx, tmp):
    """Phase 5g: the frontend's witness engines re-derive every placement of
    `fx` from its inputs alone, on phase 5d's staged library read back from
    `tmp`, and the re-derived placements prove through the CLI on 5d's CRS.

    (i) `SubcircuitCalculators` on the library dir (no `wasm/`, so every
    subcircuit must compile under `frontend/r1cs_eval`; a fallback would
    raise); (ii) `WitnessGenerator`'s solver engine (`models/witness_solver`,
    then the R1CS satisfaction check) on every placement; (iii) each witness
    == the fixture's placement variables; (iv) the compiled schedule's
    witnesses written as placementVariables.json beside 5d's instance and
    permutation, then prove --deterministic and verify through the CLI,
    every launch counter set to 0 before and read after: proof.json must be
    5d's byte for byte and hash to the pinned digest, and verify print
    true.  -> (counts, seconds)."""
    import shutil

    from tokamak_zk_evm_tpu_torch import cli
    from tokamak_zk_evm_tpu_torch.frontend.witness_calculator import SubcircuitCalculators
    from tokamak_zk_evm_tpu_torch.frontend.witness_gen import WitnessGenerator
    from tokamak_zk_evm_tpu_torch.io import artifacts as art
    from tokamak_zk_evm_tpu_torch.models.protocol import Placement
    from tokamak_zk_evm_tpu_torch.testing.synthetic import FULLSHAPE_PROOF_SHA256

    lib, synth, crs_dir, pre, prf = (os.path.join(tmp, d) for d in STAGED)
    t = {}

    def inputs(p, info):
        i0, ic = info.In_idx
        return p.variables[i0:i0 + ic]

    t0 = time.perf_counter()
    _, infos, library = art.load_library(lib)
    calcs = SubcircuitCalculators(lib)
    expect(not calcs.available(), "the staged library ships no wasm/ dir (no WASM fallback)")
    for info in infos:
        expect(calcs._compiled_for(info.id) is not False,
               f"subcircuit {info.id} ({info.name}, {len(library[info.id].A_cols)} A columns) "
               f"compiles under r1cs_eval")
    t["load_compile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    derived = [calcs.witness(p.subcircuit_id, inputs(p, infos[p.subcircuit_id]))
               for p in fx.placements]
    t["replay"] = time.perf_counter() - t0
    bad = [i for i, (w, p) in enumerate(zip(derived, fx.placements)) if w != p.variables]
    expect(not bad, f"(i) the compiled schedule re-derives all {len(derived)} placements == "
           f"the fixture's variables ({len(bad)} differ)")

    gen = WitnessGenerator(None, infos, library)
    per, bad = [], []
    for i, p in enumerate(fx.placements):
        t0 = time.perf_counter()
        w = gen.witness(p.subcircuit_id, inputs(p, infos[p.subcircuit_id]))
        per.append(time.perf_counter() - t0)
        if w != p.variables:
            bad.append(i)
    t["solver"] = sum(per)
    log(f"  solver seconds per placement: min {min(per):.4f}, median "
        f"{sorted(per)[len(per) // 2]:.4f}, max {max(per):.4f}")
    expect(not bad, f"(ii) the solver engine (then the R1CS check) re-derives all {len(per)} "
           f"placements == the fixture's variables ({len(bad)} differ)")

    synth_g, prf_g = os.path.join(tmp, "synthesizer_5g"), os.path.join(tmp, "proof_5g")
    os.makedirs(synth_g)
    for name in ("instance.json", "permutation.json"):
        shutil.copy(os.path.join(synth, name), synth_g)
    t0 = time.perf_counter()
    art.save_placement_variables(
        [Placement(p.subcircuit_id, w) for p, w in zip(fx.placements, derived)],
        os.path.join(synth_g, "placementVariables.json"))
    t["write"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    K.reset_counts()
    t0 = time.perf_counter()
    rc_p = run_cli(cli, dev, ["prove", "--crs", crs_dir, "--library", lib, "--synthesizer",
                              synth_g, "--output", prf_g, "--deterministic"])
    torch.cuda.synchronize()
    t["prove"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc_v = run_cli(cli, dev, ["verify", "--crs", crs_dir, "--library", lib, "--preprocess", pre,
                              "--proof", prf_g, "--synthesizer", synth_g])
    torch.cuda.synchronize()
    t["verify"] = time.perf_counter() - t0
    counts = K.counts()
    log("  host seconds: " + json.dumps({k: round(v, 3) for k, v in t.items()})
        + f" ({gpu_line()})")
    log("  kernels " + json.dumps(counts))
    expect(rc_p[0] == 0, "cli prove on the re-derived placements exits 0")
    with open(os.path.join(prf_g, "proof.json"), "rb") as f:
        got = f.read()
    with open(os.path.join(prf, "proof.json"), "rb") as f:
        expect(got == f.read(), "(iv) proof.json == phase 5d's, byte for byte")
    d = json.loads(got)
    digest = hashlib.sha256(art.canonical_proof_bytes(art.proof_from_solidity(d))).hexdigest()
    expect(digest == FULLSHAPE_PROOF_SHA256,
           f"(iv) proof.json digest {digest[:16]}... is the JAX package's pinned one")
    expect(rc_v == (0, "true"), "(iv) cli verify prints true (exit 0)")
    return counts, t


def dist_store(tag: str) -> tuple[str, str]:
    """(scratch dir under the checkout's `.cache/`, a FileStore path in it)
    for one process group."""
    import tempfile

    cache = os.path.join(ROOT, ".cache")
    os.makedirs(cache, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_", dir=cache)
    return tmp, os.path.join(tmp, "store")


def run_module(module: str, args: list, timeout: float, env=None) -> str:
    """`python -m module args` from the checkout, under `env` (default this
    process's), its diagnostics on this process's standard error, in a
    session of its own that is killed whole if it outlives `timeout`; fails
    unless it exits 0.  -> its standard output."""
    import signal

    env = dict(os.environ if env is None else env, PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-m", module] + args, cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{module} did not finish within {timeout:.0f} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    expect(proc.returncode == 0, f"{module} exits 0 (exit code {proc.returncode})")
    return out


def run_scaling_report(torch):
    """Phase 5f (i): `utils/scaling_report.py` on the card, one NCCL rank (a
    subprocess, the real collectives at the main path's largest shapes):
    `bintt_dist` of a 16384 x 512 grid == `bintt` and, inverse, back to the
    grid; `msm_dist` of 2^22 points c_i G and the unsharded MSM == the O(1)
    oracle (sum k_i c_i) G (the report raises on any mismatch); each timed.
    It writes the report's default file, which phase 7's bench reads.
    -> the report."""
    out = run_module("tokamak_zk_evm_tpu_torch.utils.scaling_report", [], 600,
                     dict(os.environ, SCALE_MSM_LOG2="22"))
    report = json.loads(out.strip().splitlines()[-1])
    expect(report["platform"] == "cuda" and report["backend"] == "nccl" and report["world"] == 1,
           "the report ran on one NCCL rank on the card")
    expect(report["device"]["name"] == torch.cuda.get_device_name(0), "the report names the card")
    calls = report["dist_calls"]
    expect(calls["bintt_dist"] > 0 and calls["msm_dist"] > 0, f"dist counters above zero {calls}")
    rows = {(r["op"], r["n_devices"], r["sharded"]) for r in report["rows"]}
    expect(rows == {(op, 1, sharded) for op in ("bintt_16384x512", "msm_2^22")
                    for sharded in (False, True)},
           f"the report's rows: each op unsharded and on a one-rank mesh {sorted(rows)}")
    for r in report["rows"]:
        log(f"  {r['op']} {'bintt_dist / msm_dist' if r['sharded'] else 'unsharded'}, "
            f"{r['n_devices']} rank: {r['seconds'] * 1e3:.3f} ms (efficiency "
            f"{r['efficiency']:.3f}; one rank: cost, not scaling)")
    return report


# the bench's default ladder on a machine with no warm marker, in order
BENCH_METRICS = ("prove_wall_clock_small_synthetic_n256_smax32",
                 "prove_wall_clock_mid_synthetic_n1024_smax64",
                 "prove_wall_clock_full_synthetic_n4096_smax256")


def run_bench(torch, K, report) -> tuple[list[str], dict]:
    """Phase 7: `python -m tokamak_zk_evm_tpu_torch.bench` (a subprocess),
    its default ladder with verification on, a budget that fits this run
    and a cache of its own (deleted after): every rung must bank a line of
    `bench.py`'s form naming the card, whose proof verified; the full rung's
    timed prove must have launched K1, K2, K3, K4's MSM stages and B6 and
    not K5, its proof must hash to the JAX package's pinned digest, its
    2^22-point MSM probe must have met the oracle, and its mesh table must
    be phase 5f's report.  -> (the three lines, the full rung's launches)."""
    import shutil
    import tempfile

    from tokamak_zk_evm_tpu_torch.testing.synthetic import FULLSHAPE_PROOF_SHA256

    cache = tempfile.mkdtemp(prefix="chip_smoke_7_", dir=os.path.join(ROOT, ".cache"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("TOKAMAK_BENCH_")}
    env.update(TOKAMAK_BENCH_VERIFY="1", TOKAMAK_BENCH_BUDGET_S="480", TOKAMAK_BENCH_CACHE=cache)
    try:
        out = run_module("tokamak_zk_evm_tpu_torch.bench", [], 600, env)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    got = [json.loads(ln) for ln in lines]
    expect([g["metric"] for g in got] == list(BENCH_METRICS),
           f"the ladder banked small, mid and full ({[g['metric'] for g in got]})")
    card = {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    for g in got:
        d = g["detail"]
        expect(set(g) == {"metric", "value", "unit", "vs_baseline", "detail"},
               f"{g['metric']}: bench.py's five keys")
        expect(g["unit"] == "s" and g["value"] > 0 and g["vs_baseline"] == 0.0,
               f"{g['metric']}: a time in s, vs_baseline 0.0 (a synthetic circuit)")
        expect({k: d["device"][k] for k in card} == card, f"{g['metric']}: names the card")
        expect(d["verify_snark"] is True and d["peak_device_memory_bytes"] > 0
               and {"build", "encode", "prove"} <= set(d["spans"]),
               f"{g['metric']}: verified, peak memory and the prover's span categories")
        log(f"  {g['metric']}: {g['value']} s, spans {json.dumps(d['spans'])}, peak "
            f"{d['peak_device_memory_bytes'] / 2**30:.3f} GiB ({d['device']['name']}, "
            f"{d['device']['power_limit']})")
    full = got[-1]["detail"]
    log("  full rung's timed prove, kernels " + json.dumps(full["launches"]) + "; host "
        + json.dumps(full["host_usage"]))
    expect_launches(full["launches"], [K.FR_EW.name, K.FIELD_INV.name, K.BATCH_INV.name,
                                       K.NTT.name, K.MSM_BUCKET_SUM.name, K.MSM_WINDOW.name,
                                       K.FR_SCAN.name],
                    [K.AFF_PRE.name, K.AFF_POST.name], "bench's full rung (7)")
    expect(full["proof_sha256"] == FULLSHAPE_PROOF_SHA256,
           f"full rung proof digest {full['proof_sha256'][:16]}... is the JAX package's pinned one")
    expect(full["msm_2p22_oracle"] is True and full["msm_2p22_s"] > 0 and full["bintt_2p23_s"] > 0,
           "full rung: the 2^22 MSM probe met (sum k_i c_i) G, the 2^23 biNTT probe ran")
    expect(full["scaling"]["mesh_efficiency"]["rows"] == report["rows"],
           "full rung: its mesh table is phase 5f's scaling report")
    log(f"  full rung per-op: MSM 2^22 {full['msm_2p22_s']:.4f} s, biNTT 2^23 "
        f"{full['bintt_2p23_s']:.4f} s")
    return lines, full["launches"]


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
def recording(K, b13_events=None):
    """Record, inside the block, the distinct calls of K3 (grid shape, axis
    and tables), the batch sizes of the fixed-base op, the widths of the
    batch inversions by power of two ({"Fq 2^k": calls of width in
    (2^(k-1), 2^k]}) and those of B13's add and doubling on the card
    ({"2^k": [calls, lanes]}, counted once the wrapper returns), as the
    entry points make them (`ops`, `models` and the kernel
    wrappers call them through the module).  With a list `b13_events`, each
    B13 add and doubling on the card is bracketed by two CUDA events,
    appended as (op, "2^k", start, end)."""
    import torch

    calls = {"ntt": {}, "fixed_base": set(), "batch_inv": {}, "g1_add": {}, "g1_dbl": {}}
    fr_ntt, fixed_base, batch_inv = K.fr_ntt, K.g1_fixed_base, K.batch_inv
    g1_add, g1_dbl = K.g1_add, K.g1_dbl

    def wrap(op, fn):
        def wrapped(p, *args, **kw):
            if not p[0].is_cuda:
                return fn(p, *args, **kw)
            n = int(p[0].shape[1])
            key = f"2^{max(0, n - 1).bit_length()}"
            if b13_events is None:
                out = fn(p, *args, **kw)
            else:
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                out = fn(p, *args, **kw)
                e.record()
                b13_events.append((op, key, s, e))
            c = calls[op].setdefault(key, [0, 0])  # after the wrapper launched
            c[0], c[1] = c[0] + 1, c[1] + n
            return out
        return wrapped

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
    K.g1_add, K.g1_dbl = wrap("g1_add", g1_add), wrap("g1_dbl", g1_dbl)
    try:
        yield calls
    finally:
        K.fr_ntt, K.g1_fixed_base, K.batch_inv = fr_ntt, fixed_base, batch_inv
        K.g1_add, K.g1_dbl = g1_add, g1_dbl


def b13_widths(calls, events):
    """B13's add and doubling on a recorded path: for each, calls and lanes
    by power-of-two width with their device ms and IMAD bound ms, and the
    totals."""
    per_lane = {"g1_add": JAC_ADD_MULS * FQ_MUL_OPS / IMAD_PER_S,
                "g1_dbl": DBL_MULS * FQ_MUL_OPS / IMAD_PER_S}
    ms = {}
    for op, key, s, e in events:
        ms[(op, key)] = ms.get((op, key), 0.0) + s.elapsed_time(e)
    out = {}
    for op in ("g1_add", "g1_dbl"):
        rows = {key: [c, n, round(ms.get((op, key), 0.0), 4), round(n * per_lane[op] * 1e3, 4)]
                for key, (c, n) in sorted(calls[op].items(), key=lambda kv: int(kv[0][2:]))}
        out[op] = {"by_width": rows, "calls": sum(r[0] for r in rows.values()),
                   "lanes": sum(r[1] for r in rows.values()),
                   "device_s": round(sum(r[2] for r in rows.values()) / 1e3, 4),
                   "imad_bound_s": round(sum(r[3] for r in rows.values()) / 1e3, 4)}
    return out


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
    # grand-product denominators (m_i * s_max = 2^20 Fr), then in Fq at
    # setup's xy_powers family (2^22), at 2^10, and at 1 (the latency of
    # every call); bound: the batch read and written once, 3 (n - 1)
    # products and one inversion.
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
    # K5 at 2^22 lanes, every lane a P+Q add: aff_post does its three
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
    # The rkyv CRS decode at 2^22 entries (a staging chunk holds 2^20, the
    # largest family 5.57M).  Bound: 96 B read, two 96-byte limb columns and
    # a 4-byte flag written an entry; two products.
    n = 1 << 22
    raw = crs_entries(torch, np, rng, n, dev)
    outs = ([torch.empty((K.FQ_L, n), dtype=torch.int32, device=dev) for _ in range(2)]
            + [torch.empty(n, dtype=torch.int32, device=dev)])

    def decode():
        K.crs_decode(raw, n, *outs, 0)
        return tuple(outs)

    row(K.CRS_DECODE, "2^22 entries", decode, lambda: K.plain_crs_decode(raw, n),
        (K.G1_ENTRY_BYTES + 2 * 96 + 4) * n, 2 * FQ_MUL_OPS * n)
    del raw, outs
    torch.cuda.empty_cache()
    return rows


def crs_entries(torch, np, rng, n: int, dev):
    """n rkyv G1 entries as uint8 [96 n] on `dev`: random canonical x and y;
    entries 0 and 7 all zero (infinity), entry 1's x zero, entry 2 all 0xFF."""
    from tokamak_zk_evm_tpu_torch.fields import FQ

    def half():
        return np.ascontiguousarray(rand_field(np, rng, FQ, n).T.astype("<u2")).view(np.uint8)

    ent = np.concatenate([half(), half()], 1)
    ent[[0, 7]] = 0
    ent[1, :48] = 0
    ent[2] = 0xFF
    return torch.as_tensor(ent.reshape(-1), device=dev)


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
    from tokamak_zk_evm_tpu_torch.utils import ceremony_drive as CD

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

    log("[5] main path: synthetic full shape on the card")
    fx = CD.synthetic_fixture()
    with recording(K) as calls:
        sigma, counts = drive(torch, np, K, dev, fx)
    affine = [K.AFF_PRE.name, K.AFF_POST.name]
    b13 = [K.G1_ADD.name, K.G1_DBL.name, K.G1_TO_AFFINE.name]
    # the ceremony's: setup and prove add no jacobian points on the card, and
    # setup's Fq products were its to-affine steps, now B13's affine kernel
    not_needed = b13[:2] + [K.FQ_EW.name]
    # the CRS decode reads files: phase 5 makes its CRS in memory, 5d reads it
    expect_launches(counts, [n for n in counts
                             if n not in affine + not_needed + [K.CRS_DECODE.name]],
                    affine, "pippenger path")
    log("  batch inversions by width: " + json.dumps(calls["batch_inv"]))
    log(f"[5c] K3 at each of the {len(calls['ntt'])} call signatures of phase 5 "
        f"(grid, axis, tables): kernel == plain, exact")
    check_ntt_calls(torch, K, dev, calls["ntt"])

    log("[5d] the file-contract path: the port's CLI, setup -> preprocess -> prove -> verify "
        f"through files at the synthetic full shape ({gpu_line()})")
    import shutil
    import tempfile

    os.makedirs(os.path.join(ROOT, ".cache"), exist_ok=True)
    staged = tempfile.mkdtemp(prefix="chip_smoke_5d_", dir=os.path.join(ROOT, ".cache"))
    try:
        counts_d, _, proof_zero = drive_files(torch, np, K, dev, fx, sigma, staged)
        expect_launches(counts_d, [n for n in counts_d if n not in affine + not_needed], affine,
                        "file-contract path (5d)")
        del sigma
        torch.cuda.empty_cache()
        log("[5g] the frontend: every placement re-derived from its inputs (compiled schedule, "
            "solver engine) on 5d's library, then prove and verify through the CLI on 5d's CRS")
        counts_g, _ = drive_frontend(torch, K, dev, fx, staged)
    finally:
        shutil.rmtree(staged, ignore_errors=True)
    expect_launches(counts_g, [K.FR_EW.name, K.FIELD_INV.name, K.BATCH_INV.name, K.NTT.name,
                               K.MSM_BUCKET_SUM.name, K.MSM_WINDOW.name, K.FR_SCAN.name],
                    affine, "frontend's path (5g)")

    log("[5e] the MPC ceremony at the synthetic full shape: in process (seeded), then the "
        f"CLI's mpc steps through files ({gpu_line()})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b13_e = {"events": [], "steps": {}}
    with recording(K, b13_e["events"]) as calls_e:
        K.reset_counts()
        t_e = CD.drive_ceremony(torch, np, dev, fx, b13_e)
        t_e.update(CD.drive_ceremony_files(torch, dev, fx, b13_e))
        counts_e = K.counts()
    peak_e = torch.cuda.max_memory_allocated()
    log("  seconds: " + json.dumps({k: round(v, 3) for k, v in t_e.items()}))
    log("  kernels " + json.dumps(counts_e))
    log(f"  peak device memory {peak_e / 2**30:.3f} GiB")
    widths_e = b13_widths(calls_e, b13_e["events"])
    for op in ("g1_add", "g1_dbl"):
        timed = sum(ev[0] == op for ev in b13_e["events"])
        expect(widths_e[op]["calls"] == counts_e[op] == timed,
               f"{op}: the width histogram's {widths_e[op]['calls']} calls == its "
               f"{counts_e[op]} counted launches == its {timed} timed launches")
    for op in ("g1_add", "g1_dbl"):
        log(f"  {op} by width (calls, lanes, device ms, IMAD bound ms): "
            + json.dumps(widths_e[op]["by_width"]))
        w = widths_e[op]
        log(f"  {op}: {w['calls']} calls, {w['lanes']} lane-launches, {w['device_s']:.4f} "
            f"device s (IMAD bound {w['imad_bound_s']:.4f} s)")
    for name, b in b13_e["steps"].items():
        if b["g1_add"] + b["g1_dbl"] > 0:
            log(f"  {name}: wall {t_e[name]:.3f} s, B13 device add {b['g1_add']:.4f} s, "
                f"doubling {b['g1_dbl']:.4f} s")
    del b13_e
    expect_launches(counts_e, b13 + [K.FR_EW.name, K.FQ_EW.name, K.FIELD_INV.name,
                                     K.BATCH_INV.name, K.MSM_BUCKET_SUM.name, K.MSM_WINDOW.name],
                    [], "ceremony path (5e)")

    log(f"[5f] the multi-device path ({gpu_line()}): (i) the scaling report, one rank over NCCL")
    t0 = time.perf_counter()
    report = run_scaling_report(torch)
    log(f"  (i) {time.perf_counter() - t0:.3f} s")
    log("[5f] (ii) two ranks sharing the card over gloo prove the synthetic full shape")
    ranks_f = drive_gloo_two(torch, K, proof_zero)
    del proof_zero

    log("[6] kernel times (CUDA events) beside plain versions and bounds")
    counts_5 = dict(counts)
    counts.update({n: counts_e[n] for n in b13})  # B13's path is the ceremony
    rows = measure(torch, np, K, dev, counts, sorted(calls["fixed_base"]))
    binv_row = next(r for r in rows if r["name"] == K.BATCH_INV.name)
    for r in rows:
        if r["name"] in widths_e:
            r["ceremony_5e"] = widths_e[r["name"]]
        r["launches_5d"] = counts_d[r["name"]]
        r["launches_5g"] = counts_g[r["name"]]
        r["launches_5e"] = counts_e[r["name"]]
        r["launches_5f"] = [res["kernels"][r["name"]] for res in ranks_f]
        if r["name"] in b13:
            r["launches_5"] = counts_5[r["name"]]
    binv_row["widths_5"] = calls["batch_inv"]
    next(r for r in rows if r["name"] == K.NTT.name)["nccl_one_rank_5f"] = report["rows"]

    gc.collect()  # the earlier phases' tensors: the bench finds the card as a user's would
    torch.cuda.empty_cache()
    log(f"[7] the bench's ladder ({gpu_line()}); this process holds "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB on the card")
    t0 = time.perf_counter()
    bench_lines, counts_7 = run_bench(torch, K, report)
    log(f"  {time.perf_counter() - t0:.3f} s")
    for r in rows:
        r["launches_7"] = counts_7[r["name"]]
    kernels_line = json.dumps({"kernels": rows})

    log(f"total {time.perf_counter() - t_all:.3f} s")
    for line in bench_lines:
        print(line)
    print(gpu_line())
    print(kernels_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
