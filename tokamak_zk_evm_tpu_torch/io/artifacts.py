"""Proof artifacts: the Solidity-verifier split-limb `proof.json` format.

The port's copy of the parts of the JAX package's `io/artifacts.py` that the
main path needs: `proof.json` / `preprocess.json` written in the reference's
split-limb encoding (`prove/src/lib.rs:453-524`), and the canonical proof
bytes whose SHA-256 pins the toy fixture's proof.
"""

from __future__ import annotations

import json

from ..models.protocol import Proof


# ---------------------------------------------------------------------------
# Solidity-format proof.json (split-limb G1 encoding)

_G1_ORDER = (
    ("proof0", "U"), ("proof0", "V"), ("proof0", "W"),
    ("binding", "O_mid"), ("binding", "O_prv"),
    ("proof0", "Q_AX"), ("proof0", "Q_AY"),
    ("proof2", "Q_CX"), ("proof2", "Q_CY"),
    ("proof4", "Pi_X"), ("proof4", "Pi_Y"),
    ("proof0", "B"), ("proof1", "R"),
    ("proof4", "M_Y"), ("proof4", "M_X"),
    ("proof4", "N_Y"), ("proof4", "N_X"),
    ("binding", "O_pub_free"), ("binding", "A_free"),
)

_SCALAR_ORDER = ("R_eval", "R_omegaX_eval", "R_omegaX_omegaY_eval", "V_eval")


def _split_fq(v: int) -> tuple[str, str]:
    """48-byte big-endian Fq split into 16-byte + 32-byte hex limbs
    (`iotools/mod.rs:1625-1650` split_g1)."""
    b = int(v).to_bytes(48, "big")
    return "0x" + b[:16].hex(), "0x" + b[16:].hex()


def proof_to_solidity(proof: Proof) -> dict:
    """FormattedProof (`prove/src/lib.rs:453-524`): 19 G1 points as
    (part1, part2) limb pairs per coordinate, then 4 scalar evaluations
    appended to part2 only."""
    part1: list[str] = []
    part2: list[str] = []
    for sect, name in _G1_ORDER:
        p = getattr(getattr(proof, sect), name)
        x, y = (0, 0) if p is None else (p[0], p[1])
        for coord in (x, y):
            a, b = _split_fq(coord)
            part1.append(a)
            part2.append(b)
    for name in _SCALAR_ORDER:
        v = getattr(proof.proof3, name)
        part2.append("0x" + int(v).to_bytes(32, "big").hex())
    return {"proof_entries_part1": part1, "proof_entries_part2": part2}


def preprocess_to_solidity(pre) -> dict:
    """FormattedPreprocess: s0, s1, O_pub_fix as split-limb pairs."""
    part1: list[str] = []
    part2: list[str] = []
    for p in (pre.s0, pre.s1, pre.O_pub_fix):
        x, y = (0, 0) if p is None else (p[0], p[1])
        for coord in (x, y):
            a, b = _split_fq(coord)
            part1.append(a)
            part2.append(b)
    return {"preprocess_entries_part1": part1, "preprocess_entries_part2": part2}


def canonical_proof_bytes(proof) -> bytes:
    """Sorted, compact JSON of `proof_to_solidity` (the golden digest input)."""
    d = proof_to_solidity(proof)
    return json.dumps(d, sort_keys=True, separators=(",", ":")).encode()
