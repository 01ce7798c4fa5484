"""The Fiat-Shamir transcript of the Solidity verifier, in plain Python.

A two-lane rolling Keccak-256 sponge: each absorb hashes a 100-byte buffer
(DST byte 0, then 1, at offset 3; both lanes; the value right-aligned), each
challenge a 72-byte buffer (DST 2, both lanes, a big-endian counter), masked
to its low 253 bits, 0 read as 1.  G1 coordinates absorb as 48 bytes, in two
updates (16 zero bytes and the high 16 bytes, then the low 32); the identity
absorbs as (0, 0).  Reference: `prove/src/lib.rs:3212-3395` and its commit
order, `lib.rs:3517-3727`.
"""

from __future__ import annotations

from .curve import R
from .keccak import keccak256


class Transcript:
    def __init__(self):
        self.s0 = bytes(32)
        self.s1 = bytes(32)
        self.counter = 0

    def _update(self, value: bytes):
        buf = bytearray(100)
        buf[4:36] = self.s0
        buf[36:68] = self.s1
        buf[100 - len(value):] = value
        n0 = keccak256(bytes(buf))
        buf[3] = 1
        n1 = keccak256(bytes(buf))
        self.s0, self.s1 = n0, n1

    def challenge(self) -> int:
        buf = bytearray(72)
        buf[3] = 2
        buf[4:36] = self.s0
        buf[36:68] = self.s1
        buf[68:72] = self.counter.to_bytes(4, "big")
        self.counter += 1
        raw = bytearray(keccak256(bytes(buf)))
        raw[0] &= 0x1F
        v = int.from_bytes(bytes(raw), "big")
        return v or 1

    def fr(self, x: int):
        self._update((x % R).to_bytes(32, "big"))

    def g1(self, p):
        for c in ((0, 0) if p is None else p):
            be = int(c).to_bytes(48, "big")
            self._update(bytes(16) + be[:16])
            self._update(be[16:])


def challenges(proof: dict) -> dict:
    """thetas, kappa0, chi, zeta and kappa1 of a proof (plain dict of
    points and evaluations)."""
    t = Transcript()
    for k in ("U", "V", "W", "Q_AX", "Q_AY", "B"):
        t.g1(proof[k])
    thetas = [t.challenge() for _ in range(3)]
    t.g1(proof["R"])
    kappa0 = t.challenge()
    t.g1(proof["Q_CX"])
    t.g1(proof["Q_CY"])
    chi, zeta = t.challenge(), t.challenge()
    for k in ("V_eval", "R_eval", "R_omegaX_eval", "R_omegaX_omegaY_eval"):
        t.fr(proof[k])
    kappa1 = t.challenge()
    return dict(thetas=thetas, kappa0=kappa0, chi=chi, zeta=zeta, kappa1=kappa1)
