"""The Solidity verifier's proof layout (`proof.json`), read in plain Python.

`proof_entries_part1` holds the high 16 bytes of each coordinate of 19 G1
points, `proof_entries_part2` their low 32 bytes, then the four opening
evaluations as 32-byte words (`prove/src/lib.rs:453-584`).  Every entry is
0x-prefixed hex of exactly its width; (0, 0) is the identity.
"""

from __future__ import annotations

import re

from .curve import Q, R

G1_ORDER = ("U", "V", "W", "O_mid", "O_prv", "Q_AX", "Q_AY", "Q_CX", "Q_CY",
            "Pi_X", "Pi_Y", "B", "R", "M_Y", "M_X", "N_Y", "N_X", "O_pub_free",
            "A_free")
EVAL_ORDER = ("R_eval", "R_omegaX_eval", "R_omegaX_omegaY_eval", "V_eval")


class LayoutError(ValueError):
    pass


def _hex(s, nbytes: int) -> int:
    if not isinstance(s, str) or not re.fullmatch(r"0x[0-9a-fA-F]{%d}" % (2 * nbytes), s):
        raise LayoutError(f"entry {s!r} is not 0x and {2 * nbytes} hex digits")
    return int(s, 16)


def read(d: dict) -> dict:
    """proof.json's object -> {name: (x, y) | None, eval name: int}."""
    if not isinstance(d, dict) or set(d) != {"proof_entries_part1", "proof_entries_part2"}:
        raise LayoutError("want exactly proof_entries_part1 and proof_entries_part2")
    p1, p2 = d["proof_entries_part1"], d["proof_entries_part2"]
    n = len(G1_ORDER)
    if len(p1) != 2 * n or len(p2) != 2 * n + len(EVAL_ORDER):
        raise LayoutError(f"entry counts {len(p1)}, {len(p2)}; want {2 * n}, {2 * n + 4}")
    out = {}
    for i, name in enumerate(G1_ORDER):
        x = (_hex(p1[2 * i], 16) << 256) | _hex(p2[2 * i], 32)
        y = (_hex(p1[2 * i + 1], 16) << 256) | _hex(p2[2 * i + 1], 32)
        if x >= Q or y >= Q:
            raise LayoutError(f"{name}: a coordinate is not below q")
        out[name] = None if (x, y) == (0, 0) else (x, y)
    for j, name in enumerate(EVAL_ORDER):
        v = _hex(p2[2 * n + j], 32)
        if v >= R:
            raise LayoutError(f"{name} is not below r")
        out[name] = v
    return out
