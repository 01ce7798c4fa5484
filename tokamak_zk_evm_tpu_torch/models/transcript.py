"""Fiat-Shamir transcript, bit-exact to the reference / Solidity verifier.

Replicates `RollingKeccakTranscript` (reference `prove/src/lib.rs:3212-3395`):
a two-lane rolling Keccak-256 sponge over buffers laid out exactly like the
Solidity verifier's memory (100-byte absorb with DST tags 0/1, 72-byte
challenge squeeze with DST tag 2 and a big-endian counter), FR_MASK = top
byte & 0x1f, and the zero->one fallback.  Also the commit-ordering manager
(`TranscriptManager`, lib.rs:3517-3727).

Points are host affine tuples ((x, y) Python ints) or None for infinity
(serialized as (0, 0), matching icicle's affine zero).
"""

from __future__ import annotations

from ..fields import R_MOD
from ..host.keccak import keccak256


class RollingKeccakTranscript:
    DST_0 = 0
    DST_1 = 1
    DST_CHALLENGE = 2

    def __init__(self):
        import os

        self.state0 = bytes(32)
        self.state1 = bytes(32)
        self.counter = 0
        # transcript debug mode: print every Fiat-Shamir absorption and
        # challenge, mirroring the reference's `transcript-debug` output
        # (`prove/src/lib.rs:3235-3258`) for cross-implementation diffing
        self.debug = os.environ.get("TZK_TRANSCRIPT_DEBUG", "0") == "1"

    def _update(self, value: bytes):
        assert len(value) <= 32
        if self.debug:
            import sys

            print(f"[transcript] absorb {value.hex()}", file=sys.stderr)
        buf = bytearray(100)
        buf[3] = self.DST_0
        buf[4:36] = self.state0
        buf[36:68] = self.state1
        buf[100 - len(value) :] = value
        new0 = keccak256(bytes(buf))
        buf[3] = self.DST_1
        new1 = keccak256(bytes(buf))
        self.state0, self.state1 = new0, new1

    def _challenge_raw(self) -> bytes:
        buf = bytearray(72)
        buf[3] = self.DST_CHALLENGE
        buf[4:36] = self.state0
        buf[36:68] = self.state1
        buf[68:72] = self.counter.to_bytes(4, "big")
        self.counter += 1
        return keccak256(bytes(buf))

    def get_challenge(self) -> int:
        raw = bytearray(self._challenge_raw())
        raw[0] &= 0x1F  # FR_MASK: value < 2^253 < r, no further reduction
        value = int.from_bytes(bytes(raw), "big")
        value = value if value != 0 else 1
        if self.debug:
            import sys

            print(f"[transcript] challenge[{self.counter - 1}] = {value:#x}",
                  file=sys.stderr)
        return value

    def commit_fr(self, x: int):
        self._update((x % R_MOD).to_bytes(32, "big"))

    def commit_fq(self, x: int):
        """48-byte base-field element: 16 high bytes then 32 low bytes."""
        be = int(x).to_bytes(48, "big")
        self._update(bytes(16) + be[:16])
        self._update(be[16:48])

    def commit_g1(self, p):
        x, y = (0, 0) if p is None else p
        self.commit_fq(x)
        self.commit_fq(y)


class TranscriptManager:
    """Commit ordering for the 5 proof rounds (reference lib.rs:3517-3727)."""

    def __init__(self):
        self.t = RollingKeccakTranscript()

    def add_proof0(self, proof0):
        for p in (proof0.U, proof0.V, proof0.W, proof0.Q_AX, proof0.Q_AY, proof0.B):
            self.t.commit_g1(p)

    def get_thetas(self):
        return [self.t.get_challenge() for _ in range(3)]

    def add_proof1(self, proof1):
        self.t.commit_g1(proof1.R)

    def get_kappa0(self):
        return self.t.get_challenge()

    def add_proof2(self, proof2):
        self.t.commit_g1(proof2.Q_CX)
        self.t.commit_g1(proof2.Q_CY)

    def get_chi_zeta(self):
        return self.t.get_challenge(), self.t.get_challenge()

    def add_proof3(self, proof3):
        for v in (proof3.V_eval, proof3.R_eval, proof3.R_omegaX_eval,
                  proof3.R_omegaX_omegaY_eval):
            self.t.commit_fr(v)

    def get_kappa1(self):
        return self.t.get_challenge()
