"""Dusk powers-of-tau import -- external phase-1 source for the MPC setup.

The port's copy of the JAX package's `models/dusk_pot.py` (host-only: file
parsing, arkworks point encodings, one batched transcript check), the
reference's Dusk-backed phase-1 source (`phase1_source.rs`): parse the
dusk-network/trusted-setup raw PoT file (challenge = uncompressed,
response = compressed arkworks encodings), validate the pinned SHA-256
digest and the tau-power transcript, and expose the (alpha, x) structure
the ceremony needs via the tau-only trick the reference uses
(`phase1_source.rs:629-649`):

    x        := tau
    alpha^k  := tau^(2*n*k)        (omega_exp)
    alpha^k x^h in G1 = tau^(2nk + h)

so a pure powers-of-tau transcript (up to tau^(10n) in G1, tau^(8n) in G2)
backs the whole Tokamak phase-1 accumulator
(`models/mpc_setup.Phase1Accumulator.from_dusk`).

Transcript validation improves on the reference's per-index pairing loop
(`phase1_source.rs:298-353`): one batched same-ratio check -- a random
linear combination of consecutive-power pairs collapsed into two pairings --
plus exact canonical-generator equality at tau^0 (which also pins the
y-sign convention: a global sign flip preserves pairing ratios but cannot
produce the canonical generator).

File layout (`phase1_source.rs:89-103`):
    64 B hash | (2^22-1) tau^i G1 | 2^21 tau^i G2 | ... (alpha/beta
    sections, unused here)
Point encoding is arkworks ark-serialize 0.4: little-endian field bytes,
flag bits in the top of the LAST byte (bit 6 = infinity; compressed adds
bit 7 = negative y).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..fields import Q_MOD, R_MOD
from ..host import curve as C
from ..host.pairing import multi_pairing

DUSK_HASH_BYTES = 64
DUSK_TAU_POWERS_LENGTH = 1 << 21
DUSK_TAU_POWERS_G1_LENGTH = (DUSK_TAU_POWERS_LENGTH << 1) - 1
G1_UNCOMP, G2_UNCOMP = 96, 192
G1_COMP, G2_COMP = 48, 96
CHALLENGE_BYTES = (DUSK_HASH_BYTES
                   + DUSK_TAU_POWERS_G1_LENGTH * G1_UNCOMP
                   + DUSK_TAU_POWERS_LENGTH * G2_UNCOMP
                   + DUSK_TAU_POWERS_LENGTH * G1_UNCOMP
                   + DUSK_TAU_POWERS_LENGTH * G1_UNCOMP
                   + G2_UNCOMP)
RESPONSE_BYTES = (DUSK_HASH_BYTES
                  + DUSK_TAU_POWERS_G1_LENGTH * G1_COMP
                  + DUSK_TAU_POWERS_LENGTH * G2_COMP
                  + DUSK_TAU_POWERS_LENGTH * G1_COMP
                  + DUSK_TAU_POWERS_LENGTH * G1_COMP
                  + G2_COMP)
# `phase1_source.rs:116` — digest of the pinned contribution-0015 response
PINNED_SHA256 = \
    "52c9d47e5cddd585b9b0c2e5ade6f809046d516289302871766bdc463e7be214"

_INF_FLAG = 1 << 6
_NEG_FLAG = 1 << 7


class DuskPotError(ValueError):
    pass


# ---------------------------------------------------------------------------
# arkworks 0.4 point (de)serialization over BLS12-381
# ---------------------------------------------------------------------------


def _sqrt_fq(n: int) -> int | None:
    # q = 3 mod 4: sqrt = n^((q+1)/4)
    r = pow(n, (Q_MOD + 1) // 4, Q_MOD)
    return r if r * r % Q_MOD == n % Q_MOD else None


def g1_from_bytes(b: bytes, compressed: bool):
    if compressed:
        flags = b[-1]
        x = int.from_bytes(b[:47] + bytes([b[47] & 0x3F]), "little")
        if flags & _INF_FLAG:
            return None
        y = _sqrt_fq((pow(x, 3, Q_MOD) + 4) % Q_MOD)
        if y is None:
            raise DuskPotError("compressed G1 x not on curve")
        if bool(flags & _NEG_FLAG) != (y > Q_MOD - y):
            y = Q_MOD - y
        return (x, y)
    flags = b[-1]
    x = int.from_bytes(b[:48], "little")
    y = int.from_bytes(b[48:95] + bytes([b[95] & 0x3F]), "little")
    if flags & _INF_FLAG:
        return None
    if (y * y - pow(x, 3, Q_MOD) - 4) % Q_MOD:
        raise DuskPotError("G1 point not on curve")
    return (x, y)


def g1_to_bytes(p, compressed: bool) -> bytes:
    if compressed:
        if p is None:
            return bytes(47) + bytes([_INF_FLAG])
        x, y = p
        out = bytearray(x.to_bytes(48, "little"))
        if y > Q_MOD - y:
            out[47] |= _NEG_FLAG
        return bytes(out)
    if p is None:
        return bytes(95) + bytes([_INF_FLAG])
    x, y = p
    return x.to_bytes(48, "little") + y.to_bytes(48, "little")


def _fq2_from_le(b: bytes):
    # ark Fq2: c0 then c1, little-endian each
    return (int.from_bytes(b[:48], "little"),
            int.from_bytes(b[48:96], "little"))


def _fq2_sqrt(a):
    """Square root in Fq[u]/(u^2+1), q = 3 mod 4 (complex method)."""
    from ..host.curve import Fq2

    if a == (0, 0):
        return (0, 0)
    a1 = _fq2_pow(a, (Q_MOD - 3) // 4)
    x0 = Fq2.mul(a1, a)
    alpha = Fq2.mul(a1, x0)
    if alpha == (Q_MOD - 1, 0):
        x = (Q_MOD - x0[1] if x0[1] else 0, x0[0])  # u * x0
    else:
        b = _fq2_pow(Fq2.add((1, 0), alpha), (Q_MOD - 1) // 2)
        x = Fq2.mul(b, x0)
    return x if Fq2.mul(x, x) == a else None


def _fq2_pow(a, e: int):
    from ..host.curve import Fq2

    acc = (1, 0)
    base = a
    while e:
        if e & 1:
            acc = Fq2.mul(acc, base)
        base = Fq2.mul(base, base)
        e >>= 1
    return acc


def g2_from_bytes(b: bytes, compressed: bool):
    from ..host.curve import Fq2

    if compressed:
        flags = b[-1]
        c1 = int.from_bytes(b[48:95] + bytes([b[95] & 0x3F]), "little")
        x = (int.from_bytes(b[:48], "little"), c1)
        if flags & _INF_FLAG:
            return None
        rhs = Fq2.add(Fq2.mul(Fq2.mul(x, x), x), (4, 4))
        y = _fq2_sqrt(rhs)
        if y is None:
            raise DuskPotError("compressed G2 x not on curve")
        y_neg = (Q_MOD - y[0] if y[0] else 0, Q_MOD - y[1] if y[1] else 0)
        if bool(flags & _NEG_FLAG) != _fq2_gt(y, y_neg):
            y = y_neg
        return (x, y)
    flags = b[-1]
    x = _fq2_from_le(b[:96])
    yb = bytearray(b[96:192])
    yb[95] &= 0x3F
    y = _fq2_from_le(bytes(yb))
    if flags & _INF_FLAG:
        return None
    return (x, y)


def _fq2_gt(a, b) -> bool:
    # arkworks Fq2 ordering: compare c1 first, then c0
    return (a[1], a[0]) > (b[1], b[0])


def g2_to_bytes(p, compressed: bool) -> bytes:
    if compressed:
        if p is None:
            return bytes(95) + bytes([_INF_FLAG])
        x, y = p
        out = bytearray(x[0].to_bytes(48, "little")
                        + x[1].to_bytes(48, "little"))
        y_neg = (Q_MOD - y[0] if y[0] else 0, Q_MOD - y[1] if y[1] else 0)
        if _fq2_gt(y, y_neg):
            out[95] |= _NEG_FLAG
        return bytes(out)
    if p is None:
        return bytes(191) + bytes([_INF_FLAG])
    x, y = p
    return (x[0].to_bytes(48, "little") + x[1].to_bytes(48, "little")
            + y[0].to_bytes(48, "little") + y[1].to_bytes(48, "little"))


# ---------------------------------------------------------------------------
# Source
# ---------------------------------------------------------------------------


@dataclass
class DuskPotSource:
    """Parsed + validated Dusk raw PoT transcript, exposing the reference's
    Phase1SrsSource surface (`phase1_source.rs:23-30,629-649`)."""

    tau_g1: list
    tau_g2: list
    n: int
    provenance: dict

    def g1(self):
        return self.tau_g1[0]

    def g2(self):
        return self.tau_g2[0]

    def x_g2(self):
        return self.tau_g2[1]

    def alpha_g2(self, exp_alpha: int):
        return self.tau_g2[2 * self.n * exp_alpha]

    def x_g1_range(self, exp_min: int, exp_max: int):
        return self.tau_g1[exp_min:exp_max + 1]

    def alphax_g1(self, exp_alpha: int, exp_x: int):
        if exp_alpha == 0:
            return self.tau_g1[exp_x]
        return self.tau_g1[2 * self.n * exp_alpha + exp_x]


def _batched_same_ratio(pairs_g1, g2_gen, x_g2, rng) -> bool:
    """e(sum r_i P_i, x_G2) == e(sum r_i P_{i+1}, G2) over random r."""
    rs = [int.from_bytes(rng.bytes(16), "little") for _ in pairs_g1]
    lhs = C.G1.msm_affine(rs, [p for p, _ in pairs_g1])
    rhs = C.G1.msm_affine(rs, [q for _, q in pairs_g1])
    if lhs is None or rhs is None:
        return lhs is None and rhs is None
    neg_rhs = (rhs[0], Q_MOD - rhs[1])
    return multi_pairing([lhs, neg_rhs], [x_g2, g2_gen]).is_one()


def read_dusk_pot(path: str, n: int, expected_sha256: str | None = PINNED_SHA256,
                  rng=None, file_layout: dict | None = None) -> DuskPotSource:
    """Load + validate a Dusk raw PoT file for Tokamak domain size n.

    `expected_sha256=None` skips the digest pin (synthetic test files);
    `file_layout` overrides the transcript lengths for reduced-size test
    fixtures ({'g1_len', 'g2_len'})."""
    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    digest = hashlib.sha256(data).hexdigest()
    if rng is None:
        # Fiat-Shamir-style batching coefficients: derived from the file
        # contents, so an adversarial transcript cannot be crafted against a
        # predictable linear combination (ADVICE r04; matters when callers
        # skip the SHA-256 pin via expected_sha256=None)
        seed = int.from_bytes(
            hashlib.sha256(b"tzk-dusk-ratio" + bytes.fromhex(digest)).digest(),
            "little")
        rng = np.random.default_rng(seed)
    if expected_sha256 is not None and digest != expected_sha256:
        raise DuskPotError(
            f"Dusk raw PoT SHA-256 mismatch: expected {expected_sha256}, "
            f"got {digest}")

    lay = file_layout or {}
    g1_len = lay.get("g1_len", DUSK_TAU_POWERS_G1_LENGTH)
    g2_len = lay.get("g2_len", DUSK_TAU_POWERS_LENGTH)
    unc = DUSK_HASH_BYTES + g1_len * G1_UNCOMP + g2_len * G2_UNCOMP
    cmp_ = DUSK_HASH_BYTES + g1_len * G1_COMP + g2_len * G2_COMP
    if len(data) >= unc:
        compressed, g1_sz, g2_sz = False, G1_UNCOMP, G2_UNCOMP
    elif len(data) >= cmp_:
        compressed, g1_sz, g2_sz = True, G1_COMP, G2_COMP
    else:
        raise DuskPotError(f"unsupported Dusk raw PoT file size {len(data)}")

    max_g1 = 10 * n
    max_g2 = 8 * n
    if max_g1 >= g1_len or max_g2 >= g2_len:
        raise DuskPotError(f"n={n} needs tau powers beyond the transcript")

    off = DUSK_HASH_BYTES
    tau_g1 = [
        g1_from_bytes(data[off + i * g1_sz: off + (i + 1) * g1_sz],
                      compressed)
        for i in range(max_g1 + 1)
    ]
    off2 = DUSK_HASH_BYTES + g1_len * g1_sz
    tau_g2 = [
        g2_from_bytes(data[off2 + i * g2_sz: off2 + (i + 1) * g2_sz],
                      compressed)
        for i in range(max_g2 + 1)
    ]

    if tau_g1[0] != C.G1.gen:
        raise DuskPotError("tau^0 in G1 is not the canonical generator")
    if tau_g2[0] != C.G2.gen:
        raise DuskPotError("tau^0 in G2 is not the canonical generator")
    # one G1<->G2 tau consistency pairing + batched same-ratio across powers
    neg_tau1 = (tau_g1[1][0], Q_MOD - tau_g1[1][1])
    if not multi_pairing([tau_g1[0], neg_tau1],
                         [tau_g2[1], tau_g2[0]]).is_one():
        raise DuskPotError("tau G1/G2 consistency failed")
    pairs = list(zip(tau_g1[:-1], tau_g1[1:]))
    if not _batched_same_ratio(pairs, tau_g2[0], tau_g2[1], rng):
        raise DuskPotError("tau-power transcript failed the ratio check")
    pairs2 = list(zip(tau_g2[:-1], tau_g2[1:]))
    if not _batched_same_ratio_g2(pairs2, tau_g1[0], tau_g1[1], rng):
        raise DuskPotError("G2 tau-power transcript failed the ratio check")

    return DuskPotSource(
        tau_g1=tau_g1, tau_g2=tau_g2, n=n,
        provenance={
            "source_sha256": digest,
            "expected_source_sha256": expected_sha256,
            "compressed": compressed,
            "max_g1_exp_used": max_g1,
            "max_g2_exp_used": max_g2,
            "transcript_consistency_verified": True,
        },
    )


def _batched_same_ratio_g2(pairs_g2, g1_gen, x_g1, rng) -> bool:
    """e(x_G1, sum r Q_i) == e(G1, sum r Q_{i+1})."""
    rs = [int.from_bytes(rng.bytes(16), "little") for _ in pairs_g2]
    lhs = C.G2.msm_affine(rs, [p for p, _ in pairs_g2])
    rhs = C.G2.msm_affine(rs, [q for _, q in pairs_g2])
    if lhs is None or rhs is None:
        return lhs is None and rhs is None
    neg_g1 = (g1_gen[0], Q_MOD - g1_gen[1])
    return multi_pairing([x_g1, neg_g1], [lhs, rhs]).is_one()
