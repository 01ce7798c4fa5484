"""Compiled R1CS witness evaluator: circom witness generation at native
Python speed.

The shipped subcircuit WASM calculators are exact but slow under the
from-scratch WASM translator (each call interprets millions of translated
bignum ops).  The reference's circuits
are straight-line dataflow (`<==` assignments, x^5 S-boxes, Num2Bits-style
hint splits, IsZero/IsEqual inverse hints), so their R1CS admits a STATIC
solve schedule: which constraint determines which wire, in what order, by
which rule.  This module compiles that schedule once per subcircuit and
replays it per call with plain bigint arithmetic, which makes per-SLOAD
Merkle chains and per-transaction EdDSA placements practical.

Safety: the schedule is value-independent (rule CHOICE never depends on
input values; only computed VALUES differ).  Every evaluator validates
against the WASM calculator on the caller's side (the JAX package's
tests cross-check all 14 subcircuits on random inputs), and every placement
witness is re-checked against the full constraint system by the
synthesizer (`check_r1cs_satisfaction` in `_finalize`), so a schedule gap
can only surface as a loud error, never a silent bad witness.  Inputs the
schedule cannot cover raise `UncompilableR1CS` — callers fall back to the
WASM calculator.

Ops:
  MUL   (LC_a known)*(LC_b known) -> solve single unknown in LC_c
  DIVB  (LC_a known)*(single unknown in LC_b) = LC_c known  -> divide
  LIN   pure linear row with a single unknown
  SPLIT lo + hi*2^128 = LC(known): canonical 128-bit split hint
  BITS  sum b_i 2^i = LC(known) over unknown binary wires: bit split
  ISZ   circom IsZero pair: out = (in == 0), inv hint
"""

from __future__ import annotations

from collections import defaultdict

from ..fields import R_MOD

H128 = 1 << 128


class UncompilableR1CS(ValueError):
    pass


def _rows(cols, n):
    rows = [dict() for _ in range(n)]
    for wire, col in cols.items():
        for k, coeff in col:
            c = coeff % R_MOD
            if c:
                rows[k][wire] = c
    return rows


def _lift(v):
    return v - R_MOD if v > R_MOD // 2 else v


class CompiledR1CS:
    """Static solve schedule for one subcircuit's R1CS."""

    def __init__(self, r1cs, nwires: int, in_wires: list[int],
                 bit_wires_hint: set[int] | None = None):
        n = 1 + max(
            max((k for c in (r1cs.A_cols, r1cs.B_cols, r1cs.C_cols)
                 for col in c.values() for k, _ in col), default=0), 0)
        A, B, C = (_rows(r1cs.A_cols, n), _rows(r1cs.B_cols, n),
                   _rows(r1cs.C_cols, n))
        self.nwires = nwires
        self.in_wires = list(in_wires)
        known = {0} | set(in_wires)
        # binary wires: b*(b-1) = 0 rows mark decomposition bits — circom
        # emits them as (±b)*(b∓1) = 0 with the constant folded into either
        # side
        binary = set(bit_wires_hint or ())
        for k in range(n):
            a, b, c = A[k], B[k], C[k]
            if c or not a or not b:
                continue
            wa = [w for w in a if w != 0]
            wb = [w for w in b if w != 0]
            if (len(wa) == 1 and len(wb) == 1 and wa[0] == wb[0]
                    and (0 in a) != (0 in b)):
                binary.add(wa[0])
        ops = []
        solved_rows = [False] * n
        # IsZero pairs: (in)*(inv) = 1 - out  AND  (in)*(out) = 0
        # (circomlib comparators.circom); also matches ±-scaled variants
        prodA = defaultdict(list)
        for k in range(n):
            if len(A[k]) == 1 and len(B[k]) == 1:
                prodA[next(iter(A[k]))].append(k)

        def lc_known(lc):
            return all(w == 0 or w in known for w in lc)

        def unknowns(lc):
            return [w for w in lc if w != 0 and w not in known]

        progress = True
        while progress:
            progress = False
            for k in range(n):
                if solved_rows[k]:
                    continue
                a, b, c = A[k], B[k], C[k]
                ua, ub, uc = unknowns(a), unknowns(b), unknowns(c)
                if not ua and not ub and len(uc) == 1:
                    w = uc[0]
                    ops.append(("MUL", k, w, dict(a), dict(b), dict(c)))
                    known.add(w)
                    solved_rows[k] = True
                    progress = True
                elif not ua and not uc and len(ub) == 1 and a:
                    w = ub[0]
                    ops.append(("DIVB", k, w, dict(a), dict(b), dict(c)))
                    known.add(w)
                    solved_rows[k] = True
                    progress = True
                elif not ub and not uc and len(ua) == 1 and b:
                    w = ua[0]
                    ops.append(("DIVA", k, w, dict(a), dict(b), dict(c)))
                    known.add(w)
                    solved_rows[k] = True
                    progress = True
                elif not a and not b and uc:
                    if len(uc) == 1:
                        w = uc[0]
                        ops.append(("LIN", k, w, dict(c)))
                        known.add(w)
                        solved_rows[k] = True
                        progress = True
                        continue
                    coeffs = {w: _lift(c[w]) for w in uc}
                    vals = sorted(abs(v) for v in coeffs.values())
                    signs = {v > 0 for v in coeffs.values()}
                    if (len(uc) == 2 and len(signs) == 1
                            and vals[0] == 1 and vals[1] > 1
                            and vals[1].bit_count() == 1):
                        # divmod hint: lo + hi*2^e = known (canonical —
                        # circom pairs it with a range check on lo)
                        lo = next(w for w in uc if abs(coeffs[w]) == 1)
                        hi = next(w for w in uc if abs(coeffs[w]) > 1)
                        ops.append(("SPLIT", k, lo, hi,
                                    vals[1].bit_length() - 1,
                                    next(iter(signs)), dict(c)))
                        known.update(uc)
                        solved_rows[k] = True
                        progress = True
                    elif (all(w in binary for w in uc)
                          and len(signs) == 1
                          and len({abs(v) for v in coeffs.values()})
                          == len(uc)
                          and all(v.bit_count() == 1 for v in vals)):
                        bits = sorted(
                            ((abs(coeffs[w]).bit_length() - 1), w)
                            for w in uc)
                        ops.append(("BITS", k, bits,
                                    next(iter(signs)), dict(c)))
                        known.update(uc)
                        solved_rows[k] = True
                        progress = True
                elif (len(a) == 1 and len(b) == 1 and not ua
                      and ub and uc):
                    # IsZero: (in)*(inv unknown) = LC{1, out unknown}
                    # paired with (in)*(out) = 0
                    wa = next(iter(a))
                    winv = ub[0]
                    if len(uc) == 1 and 0 in c:
                        wout = uc[0]
                        pair = next(
                            (j for j in prodA.get(wa, ())
                             if j != k and not solved_rows[j]
                             and next(iter(B[j]), None) == wout
                             and not C[j]), None)
                        if pair is not None:
                            ops.append(("ISZ", k, wa, winv, wout,
                                        dict(a), dict(b), dict(c)))
                            known.update((winv, wout))
                            solved_rows[k] = True
                            solved_rows[pair] = True
                            progress = True
        missing = [k for k in range(n) if not solved_rows[k]
                   and (unknowns(A[k]) or unknowns(B[k])
                        or unknowns(C[k]))]
        if missing:
            raise UncompilableR1CS(
                f"{len(missing)} constraints unsolvable (first: "
                f"{missing[:4]})")
        self.ops = ops
        self._known = known

    def evaluate(self, in_values: list[int]) -> list[int]:
        w = [0] * self.nwires
        w[0] = 1
        for wi, v in zip(self.in_wires, in_values):
            w[wi] = v % R_MOD
        M = R_MOD
        for op in self.ops:
            tag = op[0]
            if tag == "MUL":
                _, _, tw, a, b, c = op
                av = sum(cf if wi == 0 else cf * w[wi]
                         for wi, cf in a.items()) % M
                bv = sum(cf if wi == 0 else cf * w[wi]
                         for wi, cf in b.items()) % M
                rest = sum(cf if wi == 0 else cf * w[wi]
                           for wi, cf in c.items() if wi != tw) % M
                w[tw] = (av * bv - rest) * pow(c[tw], -1, M) % M
            elif tag in ("DIVB", "DIVA"):
                _, _, tw, a, b, c = op
                lc_known = a if tag == "DIVB" else b
                lc_unk = b if tag == "DIVB" else a
                kv = sum(cf if wi == 0 else cf * w[wi]
                         for wi, cf in lc_known.items()) % M
                cv = sum(cf if wi == 0 else cf * w[wi]
                         for wi, cf in c.items()) % M
                rest = sum(cf if wi == 0 else cf * w[wi]
                           for wi, cf in lc_unk.items() if wi != tw) % M
                if kv == 0:
                    raise UncompilableR1CS("zero divisor at eval")
                w[tw] = (cv * pow(kv, -1, M) - rest) \
                    * pow(lc_unk[tw], -1, M) % M
            elif tag == "LIN":
                _, _, tw, c = op
                rest = sum(cf if wi == 0 else cf * w[wi]
                           for wi, cf in c.items() if wi != tw) % M
                w[tw] = (-rest) * pow(c[tw], -1, M) % M
            elif tag == "SPLIT":
                _, _, lo, hi, e, pos, c = op
                rest = sum(cf if wi == 0 else cf * w[wi]
                           for wi, cf in c.items()
                           if wi != lo and wi != hi) % M
                v = (-rest) % M if pos else rest % M
                # lo + hi*2^e = v with v canonical (< r)
                w[lo] = v & ((1 << e) - 1)
                w[hi] = v >> e
            elif tag == "BITS":
                _, _, bits, pos, c = op
                bset = {wi for _, wi in bits}
                rest = sum(cf if wi == 0 else cf * w[wi]
                           for wi, cf in c.items() if wi not in bset) % M
                v = (-rest) % M if pos else rest % M
                for e, wi in bits:
                    w[wi] = (v >> e) & 1
            else:  # ISZ — circom IsZero: inv = in^-1 (0 if in==0),
                # out solved from (a LC)*(b LC) = LC_c; the paired
                # in*out === 0 row holds by construction
                _, _, wa, winv, wout, a, b, c = op
                w[winv] = pow(w[wa], -1, M) if w[wa] else 0
                av = w[wa] * next(iter(a.values())) % M
                bv = w[winv] * next(iter(b.values())) % M
                rest = sum(cf if wi == 0 else cf * w[wi]
                           for wi, cf in c.items() if wi != wout) % M
                w[wout] = (av * bv - rest) * pow(c[wout], -1, M) % M
        return w


def compile_subcircuit(r1cs, info):
    """CompiledR1CS for one library entry (inputs at In_idx)."""
    i0, ic = info.In_idx
    return CompiledR1CS(r1cs, info.Nwires, list(range(i0, i0 + ic)))
