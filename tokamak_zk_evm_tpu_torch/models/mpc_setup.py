"""MPC setup ceremony -- multi-party CRS generation.

Port of the JAX package's `models/mpc_setup.py` (the reference's
mpc-setup: `accumulator.rs`, `flows/phase2_*.rs`): a phase-1
powers-of-tau accumulator over (alpha, x) with Schnorr update proofs and a
blake2b hash chain, y as a public beacon at phase-2 prepare, and phase-2
gamma/delta/eta contributions, producing a `Sigma` with the trusted-setup
layout (models/setup.py).  Files, hashes, challenges and the draws from the
caller's rng are the JAX package's, draw for draw, so a seeded run gives
the JAX package's points and bytes.

The group work runs on the device (the card unless the caller asks for the
CPU; phase 2 on the device of the Sigma's families), where the JAX package
multiplies one host point at a time:

  * `_mul_jac`: many scalar multiplications at once, fixed windows from
    the top bit over B13's kernels (`K.g1_dbl`, `K.g1_add`, then
    `K.g1_to_affine`); phase 1's update, the four phase-2 families, the
    contributions' rescaling, the R1CS nonzeros and the checked loads' r P
    subgroup test all go through it, batched into few calls (`_mul_jobs`);
  * `_group_lagrange`: the change to the Lagrange basis in the exponent as
    an inverse group NTT, log2(size) butterfly stages P +- w^j Q with the
    1/size scale folded into the second;
  * the verifiers' random linear combinations are MSMs (`ops.msm`), with
    their weights drawn in bulk and reduced on the device.

Only the Schnorr proofs' single points, the phase-1 G2 points, the pairings
and the point additions of the vanishing families stay on the host, as in
the JAX package.

Every step is traced (`utils/timing`; nothing is recorded while the tracer
is off), each under a root of category "ceremony".

Phase 1: the roots `p1.contribute` (`Phase1Accumulator.compute`: `p1.hash`,
`p1.schnorr`, `p1.mul` -- pack, multiply and unpack every G1 power, its wait
in `sync.p1.mul` -- and `p1.g2`), `p1.load` (`from_json`, the checked load:
`p1.parse`, the host parse and on-curve tests before the subgroup test and
the G2 tests after it, and `p1.subgroup`, r P on the device, its wait in
`sync.p1.subgroup`) and `p1.verify` (`p1.hash`, `p1.schnorr`, `p1.rlc`, the
combinations' weights and MSMs, and `p2.pairing`, every pairing of the check
as in phase 2).  Counters: `p1.multiplied_points` (the G1 powers a
contribution multiplies) and `p1.checked_points` (the G1 points through the
r P test).

The circuit-specific prepare: the root `p2.prepare` (`phase2_prepare`), under
it `prep.xy` (xy_powers and the small products of y, the wait for them in
`sync.prep.xy`), `prep.lagrange` (the group NTTs), `prep.o_terms` (the R1CS
nonzeros' host bookkeeping and the Lagrange values of y), `prep.o_points`
(the nonzeros' products and the sums per wire: the waits `sync.prep.lagrange`,
`sync.prep.segments` at each level, `sync.prep.o_idx` and `sync.prep.kl`),
`prep.families` (the user, intermediate and private families and their
to-affine), `prep.tx` (the host vanishing families and y G2), and last
`sync.prep.done`, the wait for the families, so the root's seconds are the
prepare's whole time.  Counters: `prep.mul_lanes` (every lane of every
multiplication), `prep.full_scalar_lanes` (the lanes whose scalar is a power
of y, an L_i(y), a user-vector entry, a twiddle or 1/size: all but the R1CS
coefficients' products), `prep.gathered_windows` (the windows whose add
gathers each lane's table point), `prep.lagrange_points`,
`prep.r1cs_nonzeros` and `prep.out_points` (the device families' points).

Phase 2: the roots `p2.contribute` and `p2.verify`, under
them `p2.rescale` (the contribution's multiplications and to-affine,
launched without a wait before its hash, so the card rescales while the
host hashes), `p2.hash` (`_sigma_hash`; on a card each chunk's wait for its
copy to the host in `sync.p2.hash_pull`), `p2.schnorr` (the three proofs
made or checked), `sync.p2.rescale` (the contribution's wait for the
rescaling, after its proofs), `p2.g2` (the contribution's G2
multiplications), `p2.equal` (the fields a contribution must not touch; the
device compare in `sync.p2.equal`), `p2.rlc` (a random linear
combination's weights and MSMs) and `p2.pairing` (every `multi_pairing` of
a Schnorr check or of the verification, phase 1's included).  A
contribution runs `p2.rescale`, `p2.hash`, `p2.schnorr`,
`sync.p2.rescale`, `p2.g2`; a check `p2.hash`, `p2.schnorr`, `p2.equal`,
`p2.pairing`s and `p2.rlc`s.  Counters: `p2.hash_bytes` (family bytes
hashed), `p2.hash_staged_bytes` (those that came from a card through the
pinned buffers: all of them on a card, none on the CPU),
`p2.rescaled_points`, `p2.rlc_points` (points summed by the combinations'
MSMs, both sides) and `p2.pairings`.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

import numpy as np
import torch

from ..backend import kernels as K
from ..backend import limbs
from ..fields import R_MOD, fr_root_of_unity
from ..host import curve as C
from ..host.pairing import multi_pairing
from ..ops import curve as cv
from ..ops import field as F
from ..ops import msm as msm_mod
from ..utils import timing
from ..utils.device import resolve_device
from .protocol import SetupParams, SubcircuitInfo, SubcircuitR1CS
from .setup import Sigma, Sigma1, Sigma2, gen_evaled_lagrange_bases

G1 = C.G1
G2 = C.G2
LQ = K.FQ_L

N_ALPHA = 4  # Sigma needs alpha^1..alpha^4


def _ser_g1(p) -> str:
    return "inf" if p is None else f"{p[0]:x},{p[1]:x}"


def _ser_g2(p) -> str:
    if p is None:
        return "inf"
    return f"{p[0][0]:x},{p[0][1]:x},{p[1][0]:x},{p[1][1]:x}"


def _de_g1(s):
    if s == "inf":
        return None
    a, b = s.split(",")
    return (int(a, 16), int(b, 16))


def _de_g2(s):
    if s == "inf":
        return None
    a, b, c, d = s.split(",")
    return ((int(a, 16), int(b, 16)), (int(c, 16), int(d, 16)))


class CeremonyFormatError(ValueError):
    pass


def _g1_mul(p, k):
    return C.g1_scalar_mul_affine(p, k % R_MOD)


def _g2_mul(p, k):
    return C.g2_scalar_mul_affine(p, k % R_MOD)


def _rand_fr(rng) -> int:
    v = 0
    while v == 0:
        v = int.from_bytes(rng.bytes(32), "little") % R_MOD
    return v


def _rand_fr_limbs(rng, n: int, device) -> torch.Tensor:
    """n draws of `_rand_fr`, in order, as canonical limbs [16, n] on
    `device`: the 32-byte words from one `rng.bytes(32 n)` (the bytes of n
    calls of `rng.bytes(32)`), reduced mod r on the device; a word that
    reduces to 0 is dropped and one more is drawn, as `_rand_fr` does."""
    if n == 0:
        return torch.zeros((16, 0), dtype=torch.int32, device=device)
    raw = np.frombuffer(rng.bytes(32 * n), dtype="<u2").reshape(n, 16).T.astype(np.int64)
    t = torch.cat([torch.as_tensor(raw, device=device), torch.zeros((1, n), dtype=torch.int64,
                                                                    device=device)])
    P = limbs.FR_LIMBS.p(t.device)
    for _ in range(2):  # a word is below 2^256 < 3r
        d = limbs.normalize(t - P)
        t = torch.where(d[-1:] < 0, t, d)
    t = t[:16].to(torch.int32)
    zero = (t == 0).all(0)
    if bool(zero.any()):
        t = torch.cat([t[:, ~zero], _rand_fr_limbs(rng, int(zero.sum()), device)], 1)
    return t.contiguous()


# ---------------------------------------------------------------------------
# Device group work
# ---------------------------------------------------------------------------


def _jac(aff):
    """Affine device points (x, y, inf) -> contiguous jacobian triple."""
    return tuple(c.contiguous() for c in cv.affine_to_jac(*aff))


def _scalar_bits(table) -> np.ndarray:
    """Host ints below 2^256 -> their bits, [256, len(table)] bool."""
    raw = b"".join(int(k).to_bytes(32, "little") for k in table)
    words = np.frombuffer(raw, np.uint8).reshape(len(table), 32)
    return np.unpackbits(words, axis=1, bitorder="little").T.astype(bool)


_WINDOW_POINTS = 1 << 22  # the most points a window table of 4-bit digits may hold


def _lanes(P, sidx, pidx) -> int:
    """Lanes of a `_mul_jac` job: its index vectors' length, else P's points."""
    return next((int(t.shape[0]) for t in (sidx, pidx) if t is not None), int(P[0].shape[1]))


def _mul_jac(P, table, sidx=None, pidx=None, tag=None):
    """Scalar multiples of jacobian device points, one a lane, by fixed
    windows from the top over B13's kernels.  P: [24, Bp]; lane i takes the
    point P[pidx[i]] (P[i] when pidx is None) and the scalar
    table[sidx[i]] (table[i] when sidx is None, or table[0] for every lane
    when the table holds one); the scalars are host ints below 2^256, taken
    as they are.  Windows are w = 4 bits when the table of d P, d < 2^w,
    fits _WINDOW_POINTS points, else 1 (double-and-add): the table is built
    with `K.g1_add`; a window is w doublings (`K.g1_dbl`) and one add of
    the table point of each lane's digit, gathered (digit 0 gathers
    infinity, which the add passes over).  A window whose digit is the same
    in every scalar adds that row of the table without a gather, or nothing
    for 0, so one shared scalar needs no gather.  No step reads back from
    or waits for the device.  `tag`, where given, names the counters
    `<tag>.mul_lanes` (the lanes) and `<tag>.gathered_windows` (the windows
    whose add gathers).  -> jacobian [24, B]."""
    dev = P[0].device
    Bp = P[0].shape[1]
    lanes = _lanes(P, sidx, pidx)
    if sidx is None and len(table) not in (1, lanes):
        raise ValueError(f"{len(table)} scalars for {lanes} lanes")
    if tag:
        timing.count(tag + ".mul_lanes", lanes)
    w = 4 if Bp << 4 <= _WINDOW_POINTS else 1
    bits = _scalar_bits(table).reshape(256 // w, w, len(table))
    digits = (bits * (1 << np.arange(w))[None, :, None]).sum(1)  # [windows, S]
    acc = cv.jac_infinity((lanes,), dev)
    live = np.nonzero(digits.any(1))[0]
    if live.size == 0:
        return acc
    tab = [cv.jac_infinity((Bp,), dev), P]
    for _ in range(2, 1 << w):
        tab.append(K.g1_add(tab[-1], P))
    flat = dig = None
    top = int(live[-1])
    for wi in range(top, -1, -1):
        if wi < top:
            for _ in range(w):
                acc = K.g1_dbl(acc)
        row = digits[wi]
        if (row == row[0]).all():
            if row[0]:
                q = tab[int(row[0])]
                acc = K.g1_add(acc, q if pidx is None else _take(q, pidx))
            continue
        if flat is None:
            flat = _cat(*tab)
            dig = F.staged(digits, dev)
            sl = torch.arange(lanes, device=dev) if sidx is None else sidx
            pl = torch.arange(lanes, device=dev) if pidx is None else pidx
        if tag:
            timing.count(tag + ".gathered_windows")
        acc = K.g1_add(acc, _take(flat, dig[wi][sl] * Bp + pl))
    return acc


def _mul_jobs(jobs, tag=None):
    """Several `_mul_jac` jobs (P, table, sidx, pidx) as one: their lanes,
    points and scalars side by side, so they share each window's launches
    (few points: the launches are the cost).  Jobs whose points together
    would not fit a 4-bit table run apart, so that a shared scalar still
    skips its zero bits and gathers nothing.  `tag`: as in `_mul_jac`.
    -> one jacobian result a job."""
    if sum(P[0].shape[1] for P, _, _, _ in jobs) << 4 > _WINDOW_POINTS:
        return [_mul_jac(*job, tag=tag) for job in jobs]
    dev = jobs[0][0][0].device
    table, sidx, pidx, sizes = [], [], [], []
    poff = 0
    for P, tab, si, pi in jobs:
        Bp = P[0].shape[1]
        n = _lanes(P, si, pi)
        if si is None:
            si = (torch.arange(n, device=dev) if len(tab) > 1
                  else torch.zeros(n, dtype=torch.int64, device=dev))
        if pi is None:
            pi = torch.arange(n, device=dev)
        sidx.append(si + len(table))
        pidx.append(pi + poff)
        table += list(tab)
        poff += Bp
        sizes.append(n)
    out = _mul_jac(_cat(*[P for P, _, _, _ in jobs]), table, torch.cat(sidx), torch.cat(pidx),
                   tag)
    return [tuple(c.contiguous() for c in part) for part in zip(*(c.split(sizes, 1) for c in out))]


def _g1_mul_many(points, scalars):
    """Affine device points (x, y, inf) times host scalars (one int for
    every lane, or one a lane), reduced mod r first as `_g1_mul` does; scalar
    0 (or r) and infinite points give infinity.  -> affine (x, y, inf)."""
    if isinstance(scalars, int):
        table = [scalars % R_MOD]
    else:
        table = [int(k) % R_MOD for k in scalars]
    return K.g1_to_affine(_mul_jac(_jac(points), table))


def _mul_host(points, scalars, device) -> list:
    """`_g1_mul` over a list of host points (None = infinity), on `device`;
    the wait for the products in `sync.p1.mul`."""
    if not points:
        return []
    out = _g1_mul_many(cv.pack_affine(points, device), scalars)
    _wait(out[2], "p1.mul")
    return cv.unpack_affine(out)


def _wait(t: torch.Tensor, site: str) -> None:
    """The host's wait for the work queued on `t`'s card, as the span
    `sync.<site>` (on the CPU, an empty one)."""
    with timing.sync(site):
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()


def _cat(*pts):
    return tuple(torch.cat(cs, -1).contiguous() for cs in zip(*pts))


def _take(P, idx):
    return tuple(c[:, idx].contiguous() for c in P)


def _group_lagrange(groups, tag=None):
    """Inverse group NTTs.  groups: (jacobian P [24, T size], size), T
    transforms of one size side by side -> for each, out[t size + k] =
    (1/size) sum_h w^(-kh) P[t size + h], w the size-th root of unity.
    Radix-2 decimation in time over bit-reversed inputs: stage m pairs a and
    b = P[j + m] of each block of 2m and writes a + t_j b, a - t_j b,
    t_j = w^(-j size / 2m).  The twiddles of the first stage are 1 (no
    multiplication); the second multiplies both halves, a by 1/size and b by
    t_j / size, which folds the scale into it (size 2 scales after its one
    stage).  The multiplications of one stage of every group are one
    `_mul_jobs` call.  `tag`: as in `_mul_jac`, and each multiplication's
    lanes also in `<tag>.full_scalar_lanes` (a twiddle or 1/size each)."""
    X = []
    for P, size in groups:
        dev = P[0].device
        rev = K._bitrev(size, dev)
        T = P[0].shape[1] // size
        X.append(_take(P, (torch.arange(T, device=dev)[:, None] * size + rev[None, :]).reshape(-1)))
    w_inv = [pow(fr_root_of_unity(size), -1, R_MOD) for _, size in groups]
    m = 1
    while any(m <= size for _, size in groups if size > 1):
        jobs, who = [], []
        for g, (P, size) in enumerate(groups):
            B, dev = P[0].shape[1], P[0].device
            n_inv = pow(size, -1, R_MOD)
            tw = [pow(w_inv[g], j * size // (2 * m), R_MOD) for j in range(m)]
            if m == 2 and size > 2:  # every lane: a by 1/size, b by t_j / size
                table = [n_inv, n_inv] + [n_inv * t % R_MOD for t in tw]
                jobs.append((X[g], table, torch.arange(B, device=dev) % 4, None))
            elif m == 2 and size == 2:  # the scale, after the one stage
                jobs.append((X[g], [n_inv], None, None))
            elif 2 < m < size:  # the b half of each block by t_j
                hi = tuple(c.reshape(LQ, -1, 2, m)[:, :, 1, :].reshape(LQ, -1).contiguous()
                           for c in X[g])
                jobs.append((hi, tw, torch.arange(B // 2, device=dev) % m, None))
            else:
                continue
            who.append(g)
        if tag:
            timing.count(tag + ".full_scalar_lanes",
                         sum(_lanes(P, si, pi) for P, _, si, pi in jobs))
        muls = dict(zip(who, _mul_jobs(jobs, tag))) if jobs else {}
        for g, (P, size) in enumerate(groups):
            if m <= 2 and g in muls:
                X[g] = muls.pop(g)
            if m >= size:
                continue
            B = P[0].shape[1]
            halves = [c.reshape(LQ, -1, 2, m) for c in X[g]]
            lo = tuple(c[:, :, 0, :].reshape(LQ, -1).contiguous() for c in halves)
            hi = muls.get(g) or tuple(c[:, :, 1, :].reshape(LQ, -1).contiguous() for c in halves)
            s = K.g1_add(_cat(lo, lo), _cat(hi, (hi[0], K.fq_neg(hi[1]), hi[2])))
            X[g] = tuple(torch.stack([c[:, : B // 2].reshape(LQ, -1, m),
                                      c[:, B // 2:].reshape(LQ, -1, m)], 2).reshape(LQ, B)
                         for c in s)
        m *= 2
    return X


def _group_lagrange_points(points, size: int):
    """L_k(x) G for k < size from affine device points x^0 G .. x^(size-1) G
    (several transforms side by side: [24, T size]): the change to the
    Lagrange basis in the exponent, byte-equal to the JAX package's host
    loop.  -> affine (x, y, inf)."""
    return K.g1_to_affine(_group_lagrange([(_jac(points), size)])[0])


def _segment_sums(P, counts):
    """One jacobian sum per segment of consecutive lanes (segment k holds
    counts[k] >= 1 lanes): pairwise levels over the ranks inside each
    segment, on B13's add.  The host reads the segments' lengths and each
    level's lanes, waiting in `sync.prep.segments`."""
    dev = P[0].device
    with timing.sync("prep.segments"):
        counts = torch.as_tensor(counts, dtype=torch.int64, device=dev)
        top = int(counts.max())
        seg = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(seg.shape[0], device=dev) - first[seg]
    length = counts[seg]
    pts = [c.clone() for c in P]
    step = 1
    while step < top:
        with timing.sync("prep.segments"):
            i = torch.nonzero(((rank % (2 * step)) == 0) & (rank + step < length)).squeeze(1)
        s = K.g1_add(_take(pts, i), _take(pts, i + step))
        for c, v in zip(pts, s):
            c[:, i] = v
        step *= 2
    return _take(pts, first)


def _points_checked(items, device) -> list:
    """Checked deserialization of ("g1" | "g2", string) items in the JAX
    package's order: each point on its curve and in the r-order subgroup.
    Ceremony files are adversarial inputs (a contributor could plant
    small-subgroup or off-curve points that pass the batched pairing
    checks; `accumulator.rs` deserializes through arkworks' checked
    CanonicalDeserialize).  G1 points are tested on the curve on the host
    and r P == infinity for all of them at once on `device` (r itself, not
    reduced: the JAX package's `C.g1_scalar_mul_affine(p, R_MOD)` reduces r
    to 0, so its subgroup test passes every point); G2 points on the host,
    the same way.  Raises the JAX package's errors, at the first bad
    point.  Spans `p1.parse` (the parse and on-curve tests, then the walk
    with the G2 tests) and `p1.subgroup` (the device's r P, its wait in
    `sync.p1.subgroup`); counter `p1.checked_points`."""
    with timing.span("p1.parse"):
        parsed, stop = [], None
        for kind, s in items:
            if kind != "g1":
                parsed.append(None)
                continue
            try:
                parsed.append(_de_g1(s))
            except (AttributeError, ValueError) as e:  # raised where the JAX package's loop would
                stop = e
                break
        g1 = [i for i, p in enumerate(parsed) if items[i][0] == "g1" and p is not None]
        on = {i: G1.is_on_curve_affine(parsed[i]) for i in g1}
        first_off = min((i for i in g1 if not on[i]), default=len(items))
        cand = [i for i in g1 if i < first_off]  # the points the walk below reaches
    sub = {}
    if cand:
        with timing.span("p1.subgroup"):
            timing.count("p1.checked_points", len(cand))
            P = _jac(cv.pack_affine([parsed[i] for i in cand], resolve_device(device)))
            inf = K._is_zero(_mul_jac(P, [R_MOD])[2])
            _wait(inf, "p1.subgroup")
            sub = dict(zip(cand, inf.cpu().tolist()))
    with timing.span("p1.parse"):
        out = []
        for i, p in enumerate(parsed):
            kind, s = items[i]
            if kind == "g2":
                out.append(_de_g2_checked(s))
                continue
            if p is not None and not on[i]:
                raise CeremonyFormatError(f"G1 point off-curve: {s[:32]}...")
            if p is not None and not sub[i]:
                raise CeremonyFormatError(f"G1 point outside r-subgroup: {s[:32]}...")
            out.append(p)
        if stop is not None:
            raise stop
        return out


def _r_times_is_infinity(group, p) -> bool:
    """r p == infinity on the host, by double-and-add over r's own bits:
    the host curve's `scalar_mul` reduces its scalar mod r, which would
    make this 0 p and pass every point."""
    acc, base, k = group.infinity, group.from_affine(p), R_MOD
    while k:
        if k & 1:
            acc = group.add(acc, base)
        base = group.double(base)
        k >>= 1
    return group.to_affine(acc) is None


def _de_g2_checked(s):
    p = _de_g2(s)
    if p is None:
        return None
    if not G2.is_on_curve_affine(p):
        raise CeremonyFormatError(f"G2 point off-curve: {s[:32]}...")
    if not _r_times_is_infinity(G2, p):
        raise CeremonyFormatError(f"G2 point outside r-subgroup: {s[:32]}...")
    return p


def _msm(weights, points, device):
    """sum_i w_i P_i (`ops.msm`) over host points -> host affine or None."""
    px, py, pinf = cv.pack_affine(points, device)
    return msm_mod.msm(weights, px, py, pinf)


def _neg(p):
    return None if p is None else G1.to_affine(G1.neg(G1.from_affine(p)))


# ---------------------------------------------------------------------------
# Schnorr proof of knowledge of an exponent (over G1)
# ---------------------------------------------------------------------------


@dataclass
class SchnorrProof:
    X_g1: object  # x * G1 (the public update point)
    X_g2: object  # x * G2 (for the pairing ratio checks)
    R: object     # k * G1 commitment
    s: int        # k + c*x

    def to_json(self):
        return {"X_g1": _ser_g1(self.X_g1), "X_g2": _ser_g2(self.X_g2),
                "R": _ser_g1(self.R), "s": hex(self.s)}

    @staticmethod
    def from_json(d, device=None):
        X_g1, X_g2, R = _points_checked([("g1", d["X_g1"]), ("g2", d["X_g2"]),
                                         ("g1", d["R"])], device)
        return SchnorrProof(X_g1, X_g2, R, int(d["s"], 16))


def _schnorr_challenge(tag: bytes, transcript_hash: bytes, X_g1, X_g2, R) -> int:
    h = hashlib.blake2b(digest_size=32)
    h.update(tag)
    h.update(transcript_hash)
    for part in (_ser_g1(X_g1), _ser_g2(X_g2), _ser_g1(R)):
        h.update(part.encode())
    return int.from_bytes(h.digest(), "little") % R_MOD


def schnorr_prove(x: int, tag: bytes, transcript_hash: bytes, rng) -> SchnorrProof:
    X_g1 = _g1_mul(G1.gen, x)
    X_g2 = _g2_mul(G2.gen, x)
    k = _rand_fr(rng)
    R = _g1_mul(G1.gen, k)
    c = _schnorr_challenge(tag, transcript_hash, X_g1, X_g2, R)
    return SchnorrProof(X_g1, X_g2, R, (k + c * x) % R_MOD)


def _pairing_is_one(g1_points, g2_points) -> bool:
    """`multi_pairing(...).is_one()`, spanned `p2.pairing` and counted."""
    timing.count("p2.pairings")
    with timing.span("p2.pairing"):
        return multi_pairing(g1_points, g2_points).is_one()


def schnorr_verify(proof: SchnorrProof, tag: bytes, transcript_hash: bytes) -> bool:
    c = _schnorr_challenge(tag, transcript_hash, proof.X_g1, proof.X_g2, proof.R)
    # s*G1 == R + c*X_g1
    lhs = G1.scalar_mul(G1.from_affine(G1.gen), proof.s)
    rhs = G1.add(G1.from_affine(proof.R),
                 G1.scalar_mul(G1.from_affine(proof.X_g1), c))
    if G1.to_affine(lhs) != G1.to_affine(rhs):
        return False
    # X_g1 and X_g2 carry the same exponent: e(X_g1, G2) == e(G1, X_g2)
    neg = G1.to_affine(G1.neg(G1.from_affine(proof.X_g1)))
    return _pairing_is_one([neg, G1.gen], [G2.gen, proof.X_g2])


# ---------------------------------------------------------------------------
# Phase 1: powers-of-tau accumulator (alpha^1..4, x^1..x_len, alpha^k x^h)
# ---------------------------------------------------------------------------


@dataclass
class Phase1Proof:
    contributor_index: int
    proof_alpha: SchnorrProof
    proof_x: SchnorrProof

    def to_json(self):
        return {"contributor_index": self.contributor_index,
                "proof_alpha": self.proof_alpha.to_json(),
                "proof_x": self.proof_x.to_json()}

    @staticmethod
    def from_json(d, device=None):
        return Phase1Proof(d["contributor_index"],
                           SchnorrProof.from_json(d["proof_alpha"], device),
                           SchnorrProof.from_json(d["proof_x"], device))


@dataclass
class Phase1Accumulator:
    """Powers-of-tau state after `contributor_index` contributions (host
    points; the group work of `compute`, `verify` and `from_json` runs on
    `device`, default the card).

    x_g1[h]       = x^(h+1) * G1,            h in [0, x_len)
    alpha_g1[k]   = alpha^(k+1) * G1,        k in [0, 4)
    alpha_g2[k]   = alpha^(k+1) * G2
    alpha_x_g1[k][h] = alpha^(k+1) x^(h+1) * G1,  h in [0, n)
    x_g2          = x * G2
    """

    contributor_index: int
    x_len: int
    ax_len: int
    x_g1: list
    x_g2: object
    alpha_g1: list
    alpha_g2: list
    alpha_x_g1: list

    @staticmethod
    def initial(params: SetupParams) -> "Phase1Accumulator":
        x_len = max(2 * params.n, 2 * params.m_i) - 1
        # cross powers serve the QAP mixture (x^0..x^(n-1)) AND the
        # vanishing-poly zk families (alpha^k x^(h + n | m_i), h <= 2)
        ax_len = max(params.n, params.m_i) + 2
        return Phase1Accumulator(
            contributor_index=0,
            x_len=x_len,
            ax_len=ax_len,
            x_g1=[G1.gen] * x_len,
            x_g2=G2.gen,
            alpha_g1=[G1.gen] * N_ALPHA,
            alpha_g2=[G2.gen] * N_ALPHA,
            alpha_x_g1=[[G1.gen] * ax_len for _ in range(N_ALPHA)],
        )

    @staticmethod
    def from_dusk(params: SetupParams, source) -> "Phase1Accumulator":
        """Seed phase 1 from a Dusk powers-of-tau transcript
        (models/dusk_pot.py) instead of the identity state -- the
        reference's `dusk_backed_mpc_setup` flow (`phase1_source.rs`):
        x := tau, alpha^k := tau^(2nk), so the external ceremony's
        randomness is the first contribution.  Later contributors apply
        their updates on top exactly as in the native flow."""
        base = Phase1Accumulator.initial(params)
        n_src = max(params.n, params.m_i)
        assert source.n == n_src, "source sized for a different domain"
        # x_len = 2*max(n, m_i) - 1 < 2*n_src: no overlap with alpha=tau^2n
        return Phase1Accumulator(
            contributor_index=1,
            x_len=base.x_len,
            ax_len=base.ax_len,
            x_g1=source.x_g1_range(1, base.x_len),
            x_g2=source.x_g2(),
            alpha_g1=[source.alphax_g1(k + 1, 0) for k in range(N_ALPHA)],
            alpha_g2=[source.alpha_g2(k + 1) for k in range(N_ALPHA)],
            alpha_x_g1=[
                [source.alphax_g1(k + 1, h + 1) for h in range(base.ax_len)]
                for k in range(N_ALPHA)
            ],
        )

    # -- hash chain (accumulator.rs:322-345) ----------------------------
    def hash(self) -> bytes:
        h = hashlib.blake2b(digest_size=64)
        h.update(str(self.contributor_index).encode())
        for p in self.x_g1:
            h.update(_ser_g1(p).encode())
        h.update(_ser_g2(self.x_g2).encode())
        for p in self.alpha_g1:
            h.update(_ser_g1(p).encode())
        for p in self.alpha_g2:
            h.update(_ser_g2(p).encode())
        for row in self.alpha_x_g1:
            for p in row:
                h.update(_ser_g1(p).encode())
        return h.digest()

    # -- contribution (accumulator.rs:288-309) --------------------------
    def compute(self, rng, device=None) -> tuple["Phase1Accumulator", Phase1Proof]:
        """One contribution: every G1 power times its update exponent in one
        multiplication on `device` (G2 and the proofs on the host)."""
        with timing.span("p1.contribute", "ceremony"):
            return self._compute(rng, resolve_device(device))

    def _compute(self, rng, device) -> tuple["Phase1Accumulator", Phase1Proof]:
        alpha_u = _rand_fr(rng)
        x_u = _rand_fr(rng)
        with timing.span("p1.hash"):
            th = self.hash()
        with timing.span("p1.schnorr"):
            proof = Phase1Proof(
                contributor_index=self.contributor_index + 1,
                proof_alpha=schnorr_prove(alpha_u, b"tzk/p1/alpha", th, rng),
                proof_x=schnorr_prove(x_u, b"tzk/p1/x", th, rng),
            )
        xp = 1
        x_pows = []
        for _ in range(max(self.x_len, self.ax_len)):
            xp = xp * x_u % R_MOD
            x_pows.append(xp)
        a_pows = []
        ap = 1
        for _ in range(N_ALPHA):
            ap = ap * alpha_u % R_MOD
            a_pows.append(ap)
        jobs = [list(zip(self.x_g1, x_pows)), list(zip(self.alpha_g1, a_pows))]
        jobs += [[(p, a_pows[k] * x_pows[h] % R_MOD) for h, p in enumerate(row)]
                 for k, row in enumerate(self.alpha_x_g1)]
        flat = [e for job in jobs for e in job]
        with timing.span("p1.mul"):
            timing.count("p1.multiplied_points", len(flat))
            out = _mul_host([p for p, _ in flat], [w for _, w in flat], device)
        parts, at = [], 0
        for job in jobs:
            parts.append(out[at: at + len(job)])
            at += len(job)
        with timing.span("p1.g2"):
            x_g2 = _g2_mul(self.x_g2, x_u)
            alpha_g2 = [_g2_mul(p, w) for p, w in zip(self.alpha_g2, a_pows)]
        acc = Phase1Accumulator(
            contributor_index=self.contributor_index + 1,
            x_len=self.x_len,
            ax_len=self.ax_len,
            x_g1=parts[0],
            x_g2=x_g2,
            alpha_g1=parts[1],
            alpha_g2=alpha_g2,
            alpha_x_g1=parts[2:],
        )
        return acc, proof

    # -- verification (utils.rs verify_phase1_x_only) -------------------
    def verify(self, cur: "Phase1Accumulator", proof: Phase1Proof,
               rng=None, device=None) -> bool:
        """The JAX package's checks with the same draws from `rng`; its
        random linear combinations are MSMs on `device`."""
        if rng is None:
            # batching weights MUST be verifier-fresh: seeding them from the
            # previous accumulator (known to the contributor before they
            # contribute) would let a malicious update craft per-power errors
            # e_h with sum(r_h*e_h) = 0 that pass the batched checks
            from ..utils.rng import secure_rng

            rng = secure_rng()
        with timing.span("p1.verify", "ceremony"):
            return self._verify(cur, proof, rng, resolve_device(device))

    def _verify(self, cur: "Phase1Accumulator", proof: Phase1Proof, rng, device) -> bool:
        with timing.span("p1.hash"):
            th = self.hash()
        for pf, tag in ((proof.proof_alpha, b"tzk/p1/alpha"), (proof.proof_x, b"tzk/p1/x")):
            with timing.span("p1.schnorr"):
                if not schnorr_verify(pf, tag, th):
                    return False
        # update consistency: e(cur.x_g1[0], G2) == e(prev.x_g1[0], x'_G2)
        pair_checks = [
            (cur.x_g1[0], G2.gen, self.x_g1[0], proof.proof_x.X_g2),
            (cur.alpha_g1[0], G2.gen, self.alpha_g1[0], proof.proof_alpha.X_g2),
            # cur.x_g2 = x' * prev.x_g2
            (G1.gen, cur.x_g2, proof.proof_x.X_g1, self.x_g2),
        ]
        for a, b, c, d in pair_checks:
            if not _pairing_is_one([_neg(a), c], [b, d]):
                return False

        # power-sequence well-formedness, batched with random weights:
        #   e(sum r_h x_g1[h+1], G2) == e(sum r_h x_g1[h], x_g2)
        def batch_shift_check(points, g2_shift):
            if len(points) < 2:
                return True
            with timing.span("p1.rlc"):
                rs = _rand_fr_limbs(rng, len(points) - 1, device)
                hi = _msm(rs, points[1:], device)
                lo = _msm(rs, points[:-1], device)
            return _pairing_is_one([_neg(hi), lo], [G2.gen, g2_shift])

        if not batch_shift_check([G1.gen] + cur.x_g1, cur.x_g2):
            return False
        if not batch_shift_check(cur.alpha_g1, cur.alpha_g2[0]):
            return False
        # alpha_g2 sequence mirrors alpha_g1: e(alpha_g1[k], G2)==e(G1, alpha_g2[k])
        for k in range(N_ALPHA):
            if not _pairing_is_one([_neg(cur.alpha_g1[k]), G1.gen], [G2.gen, cur.alpha_g2[k]]):
                return False
        # cross terms: e(alpha_x[k][h], G2) == e(x_g1[h], alpha_g2[k]), batched
        for k in range(N_ALPHA):
            with timing.span("p1.rlc"):
                rs = _rand_fr_limbs(rng, cur.ax_len, device)
                n = min(cur.ax_len, len(cur.alpha_x_g1[k]), len(cur.x_g1[: cur.ax_len]))
                rs = rs[:, :n].contiguous()
                cross = _msm(rs, cur.alpha_x_g1[k][:n], device)
                xs = _msm(rs, cur.x_g1[:n], device)
            if not _pairing_is_one([_neg(cross), xs], [G2.gen, cur.alpha_g2[k]]):
                return False
        return cur.contributor_index == self.contributor_index + 1

    # -- persistence (file-granular, like the reference ceremony) -------
    def to_json(self):
        return {
            "contributor_index": self.contributor_index,
            "x_len": self.x_len,
            "ax_len": self.ax_len,
            "x_g1": [_ser_g1(p) for p in self.x_g1],
            "x_g2": _ser_g2(self.x_g2),
            "alpha_g1": [_ser_g1(p) for p in self.alpha_g1],
            "alpha_g2": [_ser_g2(p) for p in self.alpha_g2],
            "alpha_x_g1": [[_ser_g1(p) for p in row] for row in self.alpha_x_g1],
        }

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @staticmethod
    def from_json(d, device=None) -> "Phase1Accumulator":
        """Checked load: every point on its curve and in the r-order
        subgroup (G1's subgroup test at once on `device`)."""
        with timing.span("p1.load", "ceremony"):
            return Phase1Accumulator._from_json(d, device)

    @staticmethod
    def _from_json(d, device) -> "Phase1Accumulator":
        rows = [len(row) for row in d["alpha_x_g1"]]
        items = ([("g1", s) for s in d["x_g1"]] + [("g2", d["x_g2"])]
                 + [("g1", s) for s in d["alpha_g1"]] + [("g2", s) for s in d["alpha_g2"]]
                 + [("g1", s) for row in d["alpha_x_g1"] for s in row])
        pts = _points_checked(items, device)
        nx, na = len(d["x_g1"]), len(d["alpha_g1"])
        at = nx + 1 + na + len(d["alpha_g2"])
        alpha_x = []
        for r in rows:
            alpha_x.append(pts[at: at + r])
            at += r
        return Phase1Accumulator(
            contributor_index=d["contributor_index"],
            x_len=d["x_len"],
            ax_len=d["ax_len"],
            x_g1=pts[:nx],
            x_g2=pts[nx],
            alpha_g1=pts[nx + 1: nx + 1 + na],
            alpha_g2=pts[nx + 1 + na: nx + 1 + na + len(d["alpha_g2"])],
            alpha_x_g1=alpha_x,
        )

    @staticmethod
    def load(path: str, device=None) -> "Phase1Accumulator":
        with open(path) as f:
            return Phase1Accumulator.from_json(json.load(f), device)


# ---------------------------------------------------------------------------
# Phase 2: circuit-specific transform + gamma/delta/eta contributions
# ---------------------------------------------------------------------------


def _o_terms(library, infos, n: int, m_d: int):
    """The R1CS bookkeeping of o_j in the exponent, o_j = sum over the
    nonzeros of wire j of coeff * (alpha^(k+1) L_row(x)) G, k = 0, 1, 2
    for A, B, C: -> (basis index k n + row and coefficient of each nonzero,
    grouped by (subcircuit, wire); the group sizes; for each global wire
    the group that sets it, or the number of groups where none does).  A
    later subcircuit's touched wire overwrites an earlier one, as in the
    JAX package's loop."""
    seg_index, counts, base, coeff = {}, [], [], []
    for s, r1cs in enumerate(library):
        ents = {}
        for k, cols in enumerate((r1cs.A_cols, r1cs.B_cols, r1cs.C_cols)):
            for wire, col in cols.items():
                for row, c in col:
                    ents.setdefault(wire, []).append((k * n + row, c % R_MOD))
        for wire, e in ents.items():
            seg_index[(s, wire)] = len(counts)
            counts.append(len(e))
            base += [b for b, _ in e]
            coeff += [c for _, c in e]
    o_idx = np.full(m_d, len(counts), dtype=np.int64)
    for s, info in enumerate(infos):
        for local_idx, g in enumerate(info.flattenMap):
            if (s, local_idx) in seg_index:
                o_idx[g] = seg_index[(s, local_idx)]
    return base, coeff, counts, o_idx


def _o_points(terms, counts, o_idx):
    """The products of `_o_terms`' nonzeros (jacobian) -> o_j for every wire,
    affine [24, m_d]: one sum a (subcircuit, wire); a wire that no
    subcircuit touches, or whose sum is infinity, is infinity (the JAX
    package's None)."""
    dev = terms[0].device
    parts = [K.g1_to_affine(_segment_sums(terms, counts))] if counts else []
    parts.append((torch.zeros((LQ, 1), dtype=torch.int32, device=dev),) * 2
                 + (torch.ones(1, dtype=torch.int32, device=dev),))  # index len(counts)
    x, y, inf = _cat(*parts)
    with timing.sync("prep.o_idx"):
        o_idx = torch.as_tensor(o_idx, device=dev)
    return x[:, o_idx].contiguous(), y[:, o_idx].contiguous(), inf[o_idx].contiguous()


def _slice(aff, a, b):
    return tuple(c[..., a:b].contiguous() for c in aff)


def phase2_prepare(
    acc: Phase1Accumulator,
    y: int,
    params: SetupParams,
    library: list[SubcircuitR1CS],
    infos: list[SubcircuitInfo],
    device=None,
) -> Sigma:
    """Phase-1 powers + public beacon y -> initial Sigma with
    gamma = delta = eta = 1 (`flows/phase2_prepare.rs`).

    All x/alpha-dependent terms are evaluated IN THE EXPONENT (nobody knows
    x or alpha); y/gamma/delta/eta terms are scalar operations.  The four
    families are built on `device` (default the card) and stay there; the
    multiplications run in four `_mul_jobs` rounds (xy_powers with the
    small products of y, the Lagrange stages, the R1CS nonzeros, the three
    o-families) besides the Lagrange transforms' stages.  Spanned
    `p2.prepare`, which ends with the wait for the families.
    """
    with timing.span("p2.prepare", "ceremony"):
        return _prepare(acc, y, params, library, infos, resolve_device(device))


def _prepare(acc, y, params, library, infos, device) -> Sigma:
    n, s_max, l, l_free = params.n, params.s_max, params.l, params.l_free
    l_user, l_user_out = params.l_user, params.l_user_out
    m_i, m_d = params.m_i, params.m_D
    m_block = l_free - l_user
    m_function = l - l_free
    y %= R_MOD

    def arange(*ends):
        return torch.arange(*ends, device=device)

    # xy_powers[h * 2s_max + i] = y^i * (x^h G1), with delta_inv_alphak_yi_ty
    # (y^i t(y) alpha^k G1, delta = 1) and y G1
    with timing.span("prep.xy"):
        pow1 = [G1.gen] + acc.x_g1  # x^0..x^x_len in the exponent
        pow1_dev = cv.pack_affine(pow1, device)
        h_max = max(2 * n, 2 * m_i)
        rs_y = 2 * s_max
        y_pows = []
        yp = 1
        for _ in range(rs_y):
            y_pows.append(yp)
            yp = yp * y % R_MOD
        t_y = (pow(y, s_max, R_MOD) - 1) % R_MOD
        small = [acc.alpha_g1[k - 1] for k in range(1, 5) for _ in range(3)] + [G1.gen]
        small_sc = [(pow(y, i, R_MOD) * t_y) % R_MOD for _ in range(1, 5) for i in range(3)] + [y]
        timing.count("prep.full_scalar_lanes", h_max * rs_y + len(small))
        xy_lanes = arange(h_max * rs_y)
        xy, sm = _mul_jobs([(_jac(_slice(pow1_dev, 0, h_max)), y_pows, xy_lanes % rs_y,
                             xy_lanes // rs_y),
                            (_jac(cv.pack_affine(small, device)), small_sc, None, None)], "prep")
        del xy_lanes
        xy_powers = K.g1_to_affine(xy)
        del xy
        sm = K.g1_to_affine(sm)
        _wait(sm[2], "prep.xy")
        small = cv.unpack_affine(sm)
        dyi = [small[3 * k: 3 * k + 3] for k in range(4)]
        y_g1 = small[12]

    # Lagrange bases in the exponent, the transforms of one size side by side
    def alpha_family(k, size):  # [alpha^(k+1) G1] + alpha^(k+1) x^h G1, first `size`
        return cv.pack_affine(([acc.alpha_g1[k]] + acc.alpha_x_g1[k])[:size], device)

    with timing.span("prep.lagrange"):
        wanted = {"k": (_slice(pow1_dev, 0, m_i), m_i),                 # K_j(x) G1
                  "m": (_slice(pow1_dev, 0, l_free), l_free),           # M_j(x) G1
                  "k_a4": (alpha_family(3, m_i), m_i)}                  # a^4 K_j(x) G1
        for k in range(3):
            wanted[f"lag{k}"] = (alpha_family(k, n), n)
        sizes = sorted({size for _, size in wanted.values()})
        names = [[k for k, (_, size) in wanted.items() if size == sz] for sz in sizes]
        groups = [(_jac(_cat(*[wanted[k][0] for k in ks])), sz) for ks, sz in zip(names, sizes)]
        timing.count("prep.lagrange_points", sum(int(P[0].shape[1]) for P, _ in groups))
        outs = _group_lagrange(groups, "prep")
        lagr = {}
        for ks, sz, out in zip(names, sizes, outs):
            for t, k in enumerate(ks):
                lagr[k] = tuple(c[:, t * sz: (t + 1) * sz].contiguous() for c in out)  # jacobian
        del wanted, groups, outs

    # o_vec in the exponent: o_j = sum_k (alpha u + alpha^2 v + alpha^3 w)
    # over the x-Lagrange basis applied to the R1CS columns; lagrange_KL
    with timing.span("prep.o_terms"):
        l_vec = gen_evaled_lagrange_bases(y, s_max)  # scalars (y public)
        base, coeff, counts, o_idx = _o_terms(library, infos, n, m_d)
        base = torch.as_tensor(base, dtype=torch.int64)
    with timing.span("prep.o_points"):
        timing.count("prep.r1cs_nonzeros", len(coeff))
        timing.count("prep.full_scalar_lanes", 1)  # L_(s_max-1)(y) K_(m_i-1)(x)
        with timing.sync("prep.lagrange"):
            base = base.to(device)
        jobs = [(_cat(lagr["lag0"], lagr["lag1"], lagr["lag2"]), coeff, None, base),
                (_take(lagr["k"], arange(m_i - 1, m_i)), [l_vec[s_max - 1]], None, None)]
        if not coeff:
            jobs = jobs[1:]
        outs = _mul_jobs(jobs, "prep")
        kl = outs[-1]
        o_jac = _jac(_o_points(outs[0] if coeff else kl, counts, o_idx))
        kl = K.g1_to_affine(kl)
        _wait(kl[2], "prep.kl")
        lagrange_KL = cv.unpack_affine(kl)[0]
        del outs, jobs, base

    # gamma_inv_o_inst with gamma = 1 (`group_structures/mod.rs:408-447`):
    # user_vec[j] o_j + M_j(x) (j < l_free);
    # eta = 1: L_i(y) (o_{l+j} + alpha^4 K_j(x)), idx = j*s_max + i;
    # delta = 1: L_i(y) o_j for private wires
    with timing.span("prep.families"):
        user_vec = (
            [l_vec[0]] * l_user_out
            + [l_vec[1]] * (l_user - l_user_out)
            + [l_vec[2]] * m_block
            + [l_vec[3]] * m_function
        )
        inter_base = K.g1_add(lagr["k_a4"], _take(o_jac, arange(l, l + m_i)))
        m_prv = m_d - params.l_D
        timing.count("prep.full_scalar_lanes", l + (m_i + m_prv) * s_max)
        inter_lanes, prv_lanes = arange(m_i * s_max), arange(m_prv * s_max)
        gi, inter, prv = _mul_jobs([
            (_take(o_jac, arange(l)), user_vec, None, None),
            (inter_base, l_vec, inter_lanes % s_max, inter_lanes // s_max),
            (_take(o_jac, arange(params.l_D, m_d)), l_vec, prv_lanes % s_max,
             prv_lanes // s_max)], "prep")
        del inter_base, inter_lanes, prv_lanes, o_jac
        m_pad = _cat(lagr["m"], cv.jac_infinity((l - l_free,), device))
        gamma_inv_o_inst = K.g1_to_affine(K.g1_add(gi, m_pad))
        eta_inv_li_o_inter = K.g1_to_affine(inter)
        del inter
        delta_inv_li_o_prv = K.g1_to_affine(prv)
        del prv
        timing.count("prep.out_points", sum(int(f[2].numel()) for f in (
            xy_powers, gamma_inv_o_inst, eta_inv_li_o_inter, delta_inv_li_o_prv)))

    # vanishing-poly zk families: t_n(x) alpha^k x^h G1 etc. (delta = 1)
    def tx_family(exponent, k_alpha, hs):
        # alpha^k x^h (x^exponent - 1) G1 = alpha^k x^(h+exponent) G1 - alpha^k x^h G1
        fam = [acc.alpha_g1[k_alpha - 1]] + acc.alpha_x_g1[k_alpha - 1]
        out = []
        for h in hs:
            hi = fam[h + exponent] if h + exponent < len(fam) else None
            assert hi is not None, "phase-1 cross powers too short"
            p = G1.add(G1.from_affine(hi),
                       G1.neg(G1.from_affine(fam[h])))
            out.append(G1.to_affine(p))
        return out

    with timing.span("prep.tx"):
        t_x_n = [tx_family(n, k, range(3)) for k in (1, 2, 3)]
        dx4 = tx_family(m_i, 4, range(2))
        y_g2 = _g2_mul(G2.gen, y)
    _wait(delta_inv_li_o_prv[2], "prep.done")

    sigma1 = Sigma1(
        xy_powers=xy_powers,
        h_max=h_max,
        rs_y=rs_y,
        gamma_inv_o_inst=gamma_inv_o_inst,
        eta_inv_li_o_inter_alpha4_kj=eta_inv_li_o_inter,
        delta_inv_li_o_prv=delta_inv_li_o_prv,
        x=pow1[1],
        y=y_g1,
        delta=G1.gen,
        eta=G1.gen,
        delta_inv_alphak_xh_tx=t_x_n,
        delta_inv_alpha4_xj_tx=dx4,
        delta_inv_alphak_yi_ty=dyi,
    )
    sigma2 = Sigma2(
        alpha=acc.alpha_g2[0],
        alpha2=acc.alpha_g2[1],
        alpha3=acc.alpha_g2[2],
        alpha4=acc.alpha_g2[3],
        gamma=G2.gen,
        delta=G2.gen,
        eta=G2.gen,
        x=acc.x_g2,
        y=y_g2,
    )
    return Sigma(G=G1.gen, H=G2.gen, sigma_1=sigma1, sigma_2=sigma2,
                 lagrange_KL=lagrange_KL)


@dataclass
class Phase2Proof:
    contributor_index: int
    proof_gamma: SchnorrProof
    proof_delta: SchnorrProof
    proof_eta: SchnorrProof

    def to_json(self):
        return {"contributor_index": self.contributor_index,
                "proof_gamma": self.proof_gamma.to_json(),
                "proof_delta": self.proof_delta.to_json(),
                "proof_eta": self.proof_eta.to_json()}


_FAMILIES = ("xy_powers", "gamma_inv_o_inst", "eta_inv_li_o_inter_alpha4_kj",
             "delta_inv_li_o_prv")


HASH_CHUNK = 1 << 26  # bytes of a card tensor copied to the host at a time (64 MiB)


_RINGS: dict = {}  # card -> its two pinned HASH_CHUNK-byte host buffers and copy stream


def _ring(device):
    """The card's pinned buffers and copy stream, made on its first hash and
    kept (made anew should HASH_CHUNK outgrow them)."""
    ring = _RINGS.get(device)
    if ring is None or ring[0][0].numel() < HASH_CHUNK:
        bufs = [torch.empty(HASH_CHUNK, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
        ring = _RINGS[device] = (bufs, torch.cuda.Stream(device))
    return ring


def _hash_tensors(h, tensors, ready=None) -> None:
    """`h.update` over each tensor's bytes in order (the tensors all on the
    CPU or all on one card), with no copy on the host and no allocation on
    the device.  CPU tensors are hashed from their own buffers.  Card
    tensors go in HASH_CHUNK-byte chunks through the card's two pinned
    buffers: each chunk is copied on the copy stream, which first waits on
    `ready` (an event after which the tensors are final; by default
    recorded now on the current stream), and hashed in place while the next
    one copies; a buffer is refilled once its hash has returned."""
    tensors = [c.detach().contiguous() for c in tensors]
    for c in tensors:
        timing.count("p2.hash_bytes", c.numel() * c.element_size())
    if not tensors or not tensors[0].is_cuda:
        for c in tensors:
            h.update(c.numpy())
        return
    chunks = [flat[a: a + HASH_CHUNK] for flat in (c.view(torch.uint8).reshape(-1) for c in tensors)
              for a in range(0, flat.numel(), HASH_CHUNK)]
    bufs, stream = _ring(tensors[0].device)
    stream.wait_event(ready or torch.cuda.current_stream(tensors[0].device).record_event())
    copied = []  # (buffer, event) of each chunk staged

    def stage(k):
        buf = bufs[k % 2][: chunks[k].numel()]
        with torch.cuda.stream(stream):
            buf.copy_(chunks[k], non_blocking=True)
            copied.append((buf, stream.record_event()))

    stage(0)
    for k in range(len(chunks)):
        if k + 1 < len(chunks):
            stage(k + 1)  # into the other buffer, whose hash has returned
        buf, done = copied[k]
        with timing.sync("p2.hash_pull"):
            done.synchronize()
        h.update(buf.numpy())
        timing.count("p2.hash_staged_bytes", buf.numel())


def _sigma_hash(sigma: Sigma, ready=None) -> bytes:
    """The JAX package's transcript hash: each family's x, y and inf as the
    bytes of its limb-major uint32 array (the bit pattern of the port's
    int32 tensors), then the host points' strings.  `ready`: as in
    `_hash_tensors`."""
    h = hashlib.blake2b(digest_size=64)
    with timing.span("p2.hash"):
        _hash_tensors(h, [c for name in _FAMILIES for c in getattr(sigma.sigma_1, name)], ready)
        for p in (sigma.sigma_1.x, sigma.sigma_1.y, sigma.sigma_1.delta,
                  sigma.sigma_1.eta, sigma.lagrange_KL):
            h.update(_ser_g1(p).encode())
        for k in ("alpha", "alpha2", "alpha3", "alpha4", "gamma", "delta",
                  "eta", "x", "y"):
            h.update(_ser_g2(getattr(sigma.sigma_2, k)).encode())
    return h.digest()


def phase2_contribute(sigma: Sigma, rng) -> tuple[Sigma, Phase2Proof]:
    """One gamma/delta/eta contribution
    (`flows/phase2_next_contributor.rs:253-320`), on the device of the
    Sigma's families."""
    with timing.span("p2.contribute", "ceremony"):
        return _contribute(sigma, rng)


def _contribute(sigma: Sigma, rng) -> tuple[Sigma, Phase2Proof]:
    gamma_u = _rand_fr(rng)
    delta_u = _rand_fr(rng)
    eta_u = _rand_fr(rng)
    gamma_inv = pow(gamma_u, -1, R_MOD)
    delta_inv = pow(delta_u, -1, R_MOD)
    eta_inv = pow(eta_u, -1, R_MOD)
    s1, s2 = sigma.sigma_1, sigma.sigma_2
    device = s1.gamma_inv_o_inst[0].device
    # every family and host point times its scalar, in one round, launched
    # first: it needs nothing from the hash, so the card rescales while the
    # host hashes, and the launches wait for nothing once the points are up
    rows = s1.delta_inv_alphak_xh_tx + [s1.delta_inv_alpha4_xj_tx] + s1.delta_inv_alphak_yi_ty
    pts = [p for row in rows for p in row] + [s1.delta, s1.eta]
    with timing.span("p2.rescale"):
        packed = cv.pack_affine(pts, device)
        ready = torch.cuda.current_stream(device).record_event() if device.type == "cuda" else None
        jobs = [(_jac(s1.gamma_inv_o_inst), [gamma_inv], None, None),
                (_jac(s1.eta_inv_li_o_inter_alpha4_kj), [eta_inv], None, None),
                (_jac(s1.delta_inv_li_o_prv), [delta_inv], None, None),
                (_jac(packed), [delta_inv] * (len(pts) - 2) + [delta_u, eta_u], None, None)]
        timing.count("p2.rescaled_points", sum(int(P[0].shape[1]) for P, _, _, _ in jobs))
        muls = _mul_jobs(jobs)
        del jobs, packed  # the jacobian copies go as soon as the products are made
        gi, inter, prv, small = (K.g1_to_affine(P) for P in muls)
        del muls
    th = _sigma_hash(sigma, ready)
    with timing.span("p2.schnorr"):
        proof = Phase2Proof(
            contributor_index=0,
            proof_gamma=schnorr_prove(gamma_u, b"tzk/p2/gamma", th, rng),
            proof_delta=schnorr_prove(delta_u, b"tzk/p2/delta", th, rng),
            proof_eta=schnorr_prove(eta_u, b"tzk/p2/eta", th, rng),
        )
    with timing.sync("p2.rescale"):
        small = cv.unpack_affine(small)
    lists, at = [], 0
    for row in rows:
        lists.append(small[at: at + len(row)])
        at += len(row)
    nx = len(s1.delta_inv_alphak_xh_tx)
    new_s1 = Sigma1(
        xy_powers=s1.xy_powers,
        h_max=s1.h_max,
        rs_y=s1.rs_y,
        gamma_inv_o_inst=gi,
        eta_inv_li_o_inter_alpha4_kj=inter,
        delta_inv_li_o_prv=prv,
        x=s1.x,
        y=s1.y,
        delta=small[-2],
        eta=small[-1],
        delta_inv_alphak_xh_tx=lists[:nx],
        delta_inv_alpha4_xj_tx=lists[nx],
        delta_inv_alphak_yi_ty=lists[nx + 1:],
    )
    with timing.span("p2.g2"):
        g2 = dict(gamma=_g2_mul(s2.gamma, gamma_u), delta=_g2_mul(s2.delta, delta_u),
                  eta=_g2_mul(s2.eta, eta_u))
    new_s2 = Sigma2(alpha=s2.alpha, alpha2=s2.alpha2, alpha3=s2.alpha3, alpha4=s2.alpha4,
                    x=s2.x, y=s2.y, **g2)
    new_sigma = Sigma(G=sigma.G, H=sigma.H, sigma_1=new_s1, sigma_2=new_s2,
                      lagrange_KL=sigma.lagrange_KL)
    return new_sigma, proof


def _points_equal(a, b) -> bool:
    return (a is None and b is None) or (a is not None and b is not None
                                         and tuple(a) == tuple(b))


def _packed_equal(fam_a, fam_b) -> bool:
    return all(a.shape == b.shape and torch.equal(a, b.to(a.device))
               for a, b in zip(fam_a, fam_b))


def phase2_verify(prev: Sigma, cur: Sigma, proof: Phase2Proof,
                  rng=None) -> bool:
    """Pairing + PoK checks that `cur` is a valid contribution over `prev`.

    Every Sigma field is covered: immutable fields by exact equality,
    gamma/delta/eta-scaled fields by pairing ratio checks, and the large
    inverse-scaled families by ONE random-linear-combination pairing check
    each with verifier-fresh weights (sound: a contributor cannot predict
    the weights, so any nonzero per-point error survives the combination
    with overwhelming probability).  Mirrors `flows/phase2_verify.rs`
    except the reference checks points pairwise.  The combinations are
    MSMs on the device of `prev`'s families, with the JAX package's draws.
    """
    from ..utils.rng import secure_rng

    if rng is None:
        rng = secure_rng()
    with timing.span("p2.verify", "ceremony"):
        return _verify(prev, cur, proof, rng)


def _immutable_equal(prev: Sigma, cur: Sigma) -> bool:
    """The fields a contribution must leave byte-identical."""
    s1p, s1c, s2p, s2c = (prev.sigma_1, cur.sigma_1,
                          prev.sigma_2, cur.sigma_2)
    if not (_points_equal(prev.G, cur.G) and _points_equal(prev.H, cur.H)
            and _points_equal(prev.lagrange_KL, cur.lagrange_KL)):
        return False
    if not (_points_equal(s1p.x, s1c.x) and _points_equal(s1p.y, s1c.y)):
        return False
    if s1p.h_max != s1c.h_max or s1p.rs_y != s1c.rs_y:
        return False
    with timing.sync("p2.equal"):
        if not _packed_equal(s1p.xy_powers, s1c.xy_powers):
            return False
    return all(_points_equal(getattr(s2p, k), getattr(s2c, k))
               for k in ("alpha", "alpha2", "alpha3", "alpha4", "x", "y"))


def _verify(prev: Sigma, cur: Sigma, proof: Phase2Proof, rng) -> bool:
    device = prev.sigma_1.gamma_inv_o_inst[0].device
    th = _sigma_hash(prev)
    for tag, p in ((b"tzk/p2/gamma", proof.proof_gamma),
                   (b"tzk/p2/delta", proof.proof_delta),
                   (b"tzk/p2/eta", proof.proof_eta)):
        with timing.span("p2.schnorr"):
            if not schnorr_verify(p, tag, th):
                return False
    # -- immutable fields must be byte-identical ------------------------
    with timing.span("p2.equal"):
        if not _immutable_equal(prev, cur):
            return False
    s1p, s1c, s2p, s2c = (prev.sigma_1, cur.sigma_1,
                          prev.sigma_2, cur.sigma_2)
    # -- G2 updates carry the claimed exponents -------------------------
    #   e(G1, cur.gamma_G2) == e(X_gamma_g1, prev.gamma_G2)  etc.
    ng = G1.to_affine(G1.neg(G1.from_affine(G1.gen)))
    for g2_prev, g2_cur, pk in (
        (s2p.gamma, s2c.gamma, proof.proof_gamma),
        (s2p.delta, s2c.delta, proof.proof_delta),
        (s2p.eta, s2c.eta, proof.proof_eta),
    ):
        if not _pairing_is_one([ng, pk.X_g1], [g2_cur, g2_prev]):
            return False
    # -- sigma_1.delta / sigma_1.eta scaled by the same exponent as G2 --
    #   e(cur.s1.delta, prev.s2.delta) == e(prev.s1.delta, cur.s2.delta)
    for g1_prev, g1_cur, g2_prev, g2_cur in (
        (s1p.delta, s1c.delta, s2p.delta, s2c.delta),
        (s1p.eta, s1c.eta, s2p.eta, s2c.eta),
    ):
        nc = G1.to_affine(G1.neg(G1.from_affine(g1_cur)))
        if not _pairing_is_one([nc, g1_prev], [g2_prev, g2_cur]):
            return False

    # -- inverse-scaled families: full random-linear-combination check --
    #   cur_i = u^-1 prev_i with g2_cur = u g2_prev
    #   => e(sum w_i cur_i, g2_cur) == e(sum w_i prev_i, g2_prev)
    def rlc_check(comb_prev, comb_cur, g2_prev, g2_cur):
        if comb_prev is None and comb_cur is None:
            return True
        if comb_prev is None or comb_cur is None:
            return False
        ncb = G1.to_affine(G1.neg(G1.from_affine(comb_cur)))
        return _pairing_is_one([ncb, comb_prev], [g2_cur, g2_prev])

    def fam_check_packed(fam_prev, fam_cur, g2_prev, g2_cur):
        n_prev = int(fam_prev[2].numel())
        n_cur = int(fam_cur[2].numel())
        if n_prev != n_cur:
            return False
        with timing.span("p2.rlc"):
            ws = _rand_fr_limbs(rng, n_prev, device)
            timing.count("p2.rlc_points", 2 * n_prev)
            comb_prev, comb_cur = msm_mod.msm(ws, *fam_prev), msm_mod.msm(ws, *fam_cur)
        return rlc_check(comb_prev, comb_cur, g2_prev, g2_cur)

    if not fam_check_packed(s1p.gamma_inv_o_inst, s1c.gamma_inv_o_inst,
                            s2p.gamma, s2c.gamma):
        return False
    if not fam_check_packed(s1p.eta_inv_li_o_inter_alpha4_kj,
                            s1c.eta_inv_li_o_inter_alpha4_kj,
                            s2p.eta, s2c.eta):
        return False
    if not fam_check_packed(s1p.delta_inv_li_o_prv, s1c.delta_inv_li_o_prv,
                            s2p.delta, s2c.delta):
        return False

    # -- small delta-inverse list families ------------------------------
    def flatten(fam):
        out = []
        for item in fam:
            if isinstance(item, (list, tuple)) and item \
                    and isinstance(item[0], (list, tuple)) \
                    and not (len(item) == 2 and isinstance(item[0], int)):
                out.extend(item)
            else:
                out.append(item)
        return out

    def fam_check_list(list_prev, list_cur, g2_prev, g2_cur):
        pts_prev, pts_cur = flatten(list_prev), flatten(list_cur)
        if len(pts_prev) != len(pts_cur):
            return False
        with timing.span("p2.rlc"):
            live_prev, live_cur, ws = [], [], []
            for a, b in zip(pts_prev, pts_cur):
                if (a is None) != (b is None):
                    return False
                if a is None:
                    continue
                ws.append(_rand_fr(rng))
                live_prev.append(a)
                live_cur.append(b)
            if not ws:
                return rlc_check(None, None, g2_prev, g2_cur)
            timing.count("p2.rlc_points", 2 * len(ws))
            w = msm_mod.scalars_from_ints(ws, device)
            comb_prev, comb_cur = _msm(w, live_prev, device), _msm(w, live_cur, device)
        return rlc_check(comb_prev, comb_cur, g2_prev, g2_cur)

    for fam_prev, fam_cur in (
        (s1p.delta_inv_alphak_xh_tx, s1c.delta_inv_alphak_xh_tx),
        ([s1p.delta_inv_alpha4_xj_tx], [s1c.delta_inv_alpha4_xj_tx]),
        (s1p.delta_inv_alphak_yi_ty, s1c.delta_inv_alphak_yi_ty),
    ):
        if not fam_check_list(fam_prev, fam_cur, s2p.delta, s2c.delta):
            return False
    return True
