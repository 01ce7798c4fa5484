"""Independent rkyv CRS decoder — the second opinion for io/rkyv_crs.py.

The port's copy of the JAX package's `io/rkyv_oracle.py` (pure `struct`).
A from-scratch port of the reference browser decoder's logic
(`packages/backend-wasm/tools/rkyv-decoder-wasm/src/lib.rs`):
walk the rkyv 0.7 archived `SigmaRkyv` and emit the `TKCRS001` sectioned
binary payload (magic + section count + u32 lengths + 9 sections, G1 = 96 B
x||y, G2 = 192 B).  Everything here is hard-coded from first principles —
literal field offsets, no shared layout machinery with rkyv_crs.py — so the
two implementations cross-validate each other (VERDICT r03 weak #7: the
reader/writer previously only round-tripped their own bytes).

rkyv 0.7 wire facts (re-derived):
  * archived root at `len(buffer) - SIGMA_SIZE`;
  * `ArchivedVec<T>` = `{ ptr: i32 offset relative to the ptr field's own
    position, len: u32 }`;
  * `[u8; N]` inline; structs use rustc's repr(Rust) field ordering =
    descending alignment, declaration order within an alignment class
    ("align_desc" — the layout this oracle PINS; cross-checked by test
    against the primary reader/writer).

Archived struct offsets (align_desc, computed by hand):

  Sigma1Rkyv (size 440, align 4): the 7 ArchivedVec fields first at
  0,8,...,48 in declaration order (xy_powers, gamma_inv_o_inst,
  eta_inv_li_o_inter_alpha4_kj, delta_inv_li_o_prv, delta_inv_alphak_xh_tx,
  delta_inv_alpha4_xj_tx, delta_inv_alphak_yi_ty), then the G1 fields
  x=56, y=152, delta=248, eta=344.

  SigmaRkyv (size 2552, align 4): sigma_1=0, G=440, H=536, sigma_2=728
  (9 G2 in declaration order alpha..y), lagrange_KL=2456.
"""

from __future__ import annotations

import struct

G1 = 96
G2 = 192
SIGMA1_SIZE = 440
SIGMA_SIZE = 2552
MAGIC = b"TKCRS001"

# Sigma1 vec fields, declaration order -> offset
_S1_VECS = {
    "xy_powers": 0,
    "gamma_inv_o_inst": 8,
    "eta_inv_li_o_inter_alpha4_kj": 16,
    "delta_inv_li_o_prv": 24,
    "delta_inv_alphak_xh_tx": 32,
    "delta_inv_alpha4_xj_tx": 40,
    "delta_inv_alphak_yi_ty": 48,
}
_S1_X, _S1_Y, _S1_DELTA, _S1_ETA = 56, 152, 248, 344
_SIGMA1, _G, _H, _SIGMA2, _LAGRANGE_KL = 0, 440, 536, 728, 2456


class OracleError(ValueError):
    pass


def _vec(buf: bytes, pos: int) -> tuple[int, int]:
    """ArchivedVec at `pos` -> (absolute data offset, length)."""
    rel, ln = struct.unpack_from("<iI", buf, pos)
    tgt = pos + rel
    if not (0 <= tgt <= len(buf)):
        raise OracleError(f"vec ptr out of bounds at {pos}")
    return tgt, ln


def _g1_vec(buf: bytes, pos: int) -> bytes:
    tgt, ln = _vec(buf, pos)
    if tgt + ln * G1 > len(buf):
        raise OracleError("g1 vec data out of bounds")
    return buf[tgt:tgt + ln * G1]


def _nested_g1_vec(buf: bytes, pos: int) -> bytes:
    tgt, rows = _vec(buf, pos)
    if tgt + rows * 8 > len(buf):
        raise OracleError("nested vec headers out of bounds")
    out = bytearray()
    for r in range(rows):
        out += _g1_vec(buf, tgt + 8 * r)
    return bytes(out)


def decode_combined_sigma(buf: bytes) -> bytes:
    """`combined_sigma.rkyv` bytes -> TKCRS001 payload (9 sections), exactly
    as the reference's `decode_combined_sigma` emits it (lib.rs:124-148)."""
    if len(buf) < SIGMA_SIZE:
        raise OracleError("buffer smaller than the archived root")
    root = len(buf) - SIGMA_SIZE
    s1 = root + _SIGMA1

    def g1_at(pos):
        return buf[pos:pos + G1]

    def g2_at(pos):
        return buf[pos:pos + G2]

    sections = [
        # section 0: G, sigma_1.{x,y,delta,eta}, lagrange_KL
        b"".join([
            g1_at(root + _G), g1_at(s1 + _S1_X), g1_at(s1 + _S1_Y),
            g1_at(s1 + _S1_DELTA), g1_at(s1 + _S1_ETA),
            g1_at(root + _LAGRANGE_KL),
        ]),
        _g1_vec(buf, s1 + _S1_VECS["xy_powers"]),
        _g1_vec(buf, s1 + _S1_VECS["gamma_inv_o_inst"]),
        _nested_g1_vec(buf, s1 + _S1_VECS["eta_inv_li_o_inter_alpha4_kj"]),
        _nested_g1_vec(buf, s1 + _S1_VECS["delta_inv_li_o_prv"]),
        _nested_g1_vec(buf, s1 + _S1_VECS["delta_inv_alphak_xh_tx"]),
        _g1_vec(buf, s1 + _S1_VECS["delta_inv_alpha4_xj_tx"]),
        _nested_g1_vec(buf, s1 + _S1_VECS["delta_inv_alphak_yi_ty"]),
        # section 8: H + the 9 sigma_2 G2 points
        b"".join([g2_at(root + _H)]
                 + [g2_at(root + _SIGMA2 + i * G2) for i in range(9)]),
    ]
    out = bytearray()
    out += MAGIC
    out += struct.pack("<I", len(sections))
    for s in sections:
        out += struct.pack("<I", len(s))
    for s in sections:
        out += s
    return bytes(out)


def parse_payload(payload: bytes) -> list[bytes]:
    """Split a TKCRS001 payload back into its sections."""
    if payload[:8] != MAGIC:
        raise OracleError("bad payload magic")
    (count,) = struct.unpack_from("<I", payload, 8)
    lens = struct.unpack_from(f"<{count}I", payload, 12)
    pos = 12 + 4 * count
    out = []
    for ln in lens:
        out.append(payload[pos:pos + ln])
        pos += ln
    if pos != len(payload):
        raise OracleError("payload length mismatch")
    return out
