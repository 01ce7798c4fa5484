"""Generic R1CS witness solver — circom witness generation without WASM.

The reference computes per-placement witnesses by running each subcircuit's
circom-generated WASM calculator (`frontend/synthesizer/core/src/
circuitGenerator/handlers/variableGenerator.ts:33,88,356`).  This module
derives the witness directly from the binary R1CS instead, using the
structure circom compiles into its constraints:

  * single-unknown propagation — when a constraint's unknowns reduce to one
    wire appearing linearly, solve for it (covers `<==` assignments,
    IsZero's `in*out = 0` and `out = 1 - in*inv` pair, products, etc.);
  * binary-wire detection — `w * (w - 1) = 0`-shaped constraints mark wires
    as bits (and solve them outright when only one of {0,1} satisfies);
  * power-of-two bit-group extraction — a stalled linear constraint whose
    unknowns are all binary with distinct +/-2^e coefficients is a
    Num2Bits decomposition: assign the bits of the lifted integer target
    (covers Num2Bits / LessThan / carry decompositions); bound-forcing
    handles zero-sum rows (`unsupported_selector_sum === 0`);
  * sparse Gaussian elimination over the stalled linear rows — circom's
    optimizer eliminates intermediate linear wires, leaving decomposition
    rows entangled with composite unknowns; elimination disentangles them
    so singletons and pure bit-groups reappear;
  * zero-defaulting of never-determined wires (circom sets hint wires like
    IsZero's `inv` to 0 when unconstrained), followed by a FULL
    satisfaction check over every constraint.

Solved witnesses are exact; the final check makes a wrong heuristic an
error, never a silent bad witness.
"""

from __future__ import annotations

from collections import defaultdict

from ..fields import R_MOD


class UnsolvableR1CS(ValueError):
    pass


def _rows_from_cols(cols):
    rows: dict[int, dict[int, int]] = defaultdict(dict)
    for wire, col in cols.items():
        for k, coeff in col:
            c = coeff % R_MOD
            if c:
                rows[k][wire] = c
    return rows


def _lift(v: int) -> int:
    """Interpret a field element as a small signed integer when possible."""
    v %= R_MOD
    if v < (1 << 140):
        return v
    if R_MOD - v < (1 << 140):
        return -(R_MOD - v)
    return None  # type: ignore[return-value]


def _linear_row(a0, ua, b0, ub, c0, uc):
    """Reduce `(a0+Σua)(b0+Σub) = c0+Σuc` to one linear row when at most
    one product side carries unknowns: returns ({wire: coeff}, target) with
    Σ coeff·w = target, or None when both product sides have unknowns."""
    if ua and ub:
        return None
    row: dict[int, int] = {}
    if not ua:
        scale, group = a0, ub
    else:
        scale, group = b0, ua
    for w, c in group.items():
        row[w] = (scale * c) % R_MOD
    for w, c in uc.items():
        row[w] = (row.get(w, 0) - c) % R_MOD
    row = {w: c for w, c in row.items() if c}
    target = (c0 - a0 * b0) % R_MOD
    return row, target


class _Constraint:
    __slots__ = ("a", "b", "c", "wires")

    def __init__(self, a, b, c):
        self.a = a
        self.b = b
        self.c = c
        self.wires = set(a) | set(b) | set(c)


def _split(side, values):
    """Linear side -> (known constant, {unknown wire: coeff})."""
    const = 0
    unk = {}
    for w, coeff in side.items():
        v = values[w]
        if v is None:
            unk[w] = coeff
        else:
            const = (const + coeff * v) % R_MOD
    return const, unk


def solve_r1cs_witness(r1cs, nwires: int, known: dict[int, int],
                       max_rounds: int = 200, debug_state: dict = None,
                       verbose: bool = False) -> list[int]:
    """Solve the full wire assignment from `known` (must include wire 0 = 1
    and all circuit inputs).  Returns the witness list; raises
    UnsolvableR1CS when propagation cannot complete or the result does not
    satisfy the system."""
    a_rows = _rows_from_cols(r1cs.A_cols)
    b_rows = _rows_from_cols(r1cs.B_cols)
    c_rows = _rows_from_cols(r1cs.C_cols)
    n_k = max(list(a_rows) + list(b_rows) + list(c_rows), default=-1) + 1
    cons = [
        _Constraint(a_rows.get(k, {}), b_rows.get(k, {}), c_rows.get(k, {}))
        for k in range(n_k)
    ]

    values: list = [None] * nwires
    for w, v in known.items():
        values[w] = v % R_MOD
    binary: set[int] = set()

    # structural marking: circomlib IsZero compiles to the row pair
    #   in*inv = k0 - k0*out   and   in*out = 0
    # whose `out` is always 0/1 even though no binarity row exists.  Mark
    # such outs binary so the enumerator/bit-group/branch machinery can use
    # them (needed by IsZero256's `final_check === 1` product rows).
    _zero_c = set()
    for con in cons:
        if not con.c and len(con.a) == 1 and len(con.b) == 1:
            (wa,) = con.a
            (wb,) = con.b
            _zero_c.add((wa, wb))
            _zero_c.add((wb, wa))
    for con in cons:
        if len(con.a) == 1 and len(con.b) == 1 and len(con.c) == 2 \
                and 0 in con.c:
            (win,) = con.a
            (wout,) = (w for w in con.c if w != 0)
            if (win, wout) in _zero_c:
                binary.add(wout)

    by_wire: dict[int, list[int]] = defaultdict(list)
    for i, con in enumerate(cons):
        for w in con.wires:
            by_wire[w].append(i)

    pending = set(range(len(cons)))

    def eval_sides(con):
        return (_split(con.a, values), _split(con.b, values),
                _split(con.c, values))

    def try_constraint(i) -> list[int]:
        """Attempt to resolve constraint i; returns newly solved wires."""
        con = cons[i]
        (a0, ua), (b0, ub), (c0, uc) = eval_sides(con)
        # zero-product elision: a fully-known zero side makes the product
        # zero regardless of the other side's unknowns (mux terms
        # `flag * out` with flag = 0)
        if a0 == 0 and not ua:
            b0, ub = 0, {}
        elif b0 == 0 and not ub:
            a0, ua = 0, {}
        unk = set(ua) | set(ub) | set(uc)
        if not unk:
            if (a0 * b0 - c0) % R_MOD != 0:
                raise UnsolvableR1CS(f"constraint {i} violated")
            return []
        if len(unk) == 1:
            (w,) = unk
            aw, bw, cw = ua.get(w, 0), ub.get(w, 0), uc.get(w, 0)
            # (a0 + aw x)(b0 + bw x) = c0 + cw x
            # quadratic coeff q2 x^2 + q1 x + q0 = 0
            q2 = (aw * bw) % R_MOD
            q1 = (aw * b0 + bw * a0 - cw) % R_MOD
            q0 = (a0 * b0 - c0) % R_MOD
            if q2 == 0:
                if q1 == 0:
                    if q0 != 0:
                        raise UnsolvableR1CS(f"constraint {i} violated")
                    return []  # x unconstrained here
                values[w] = (-q0 * pow(q1, -1, R_MOD)) % R_MOD
                return [w]
            # quadratic: accept only when it is a binary-style constraint
            # with a unique consistent root among {0, 1}
            roots = [
                r for r in (0, 1)
                if (q2 * r * r + q1 * r + q0) % R_MOD == 0
            ]
            if len(roots) == 2:
                binary.add(w)
                return []
            if len(roots) == 1 and w in binary:
                values[w] = roots[0]
                return [w]
            return []
        # small all-binary unknown sets: exact enumeration; assign the
        # variables that take the same value in every satisfying assignment
        # (covers `out0*out1 = 1`, XOR/AND/OR rows, mux-selector products)
        if len(unk) <= 3 and all(w in binary for w in unk):
            order = sorted(unk)
            sat = []
            for m in range(1 << len(order)):
                asg = {w: (m >> j) & 1 for j, w in enumerate(order)}
                av = (a0 + sum(ua.get(w, 0) * v for w, v in asg.items()))
                bv = (b0 + sum(ub.get(w, 0) * v for w, v in asg.items()))
                cv = (c0 + sum(uc.get(w, 0) * v for w, v in asg.items()))
                if (av * bv - cv) % R_MOD == 0:
                    sat.append(asg)
            if not sat:
                raise UnsolvableR1CS(f"constraint {i} violated")
            solved = []
            for w in order:
                vals = {asg[w] for asg in sat}
                if len(vals) == 1:
                    values[w] = vals.pop()
                    solved.append(w)
            if solved:
                return solved

        # multi-unknown: if at most one product side carries unknowns the
        # constraint is one linear row over its unknowns
        lr = _linear_row(a0, ua, b0, ub, c0, uc)
        if lr is None:
            return []
        row, target = lr
        if not row:
            if target % R_MOD != 0:
                raise UnsolvableR1CS(f"constraint {i} violated")
            return []
        if len(row) == 1:
            (w,) = row
            values[w] = (target * pow(row[w], -1, R_MOD)) % R_MOD
            return [w]
        return try_bit_group(row, target)

    def try_divmod(group, target):
        """Solve the div-mod hint rows circom's `<--` quotient/remainder
        pattern compiles to (`qap-compiler/templates/256bit/
        arithmetic_unsafe_type1.circom:14-17,73-84`, 128bit carries,
        Div/Mod's `in1 = q*in2 + r`): a row with exactly two unknowns
        `s1*lo + c*hi = T` where |s1| = 1, solved as lo = remainder and
        hi = quotient of the integer target by |c|.  The full end-of-solve
        satisfaction check guards against misapplication."""
        if len(group) != 2:
            return []
        (w1, c1), (w2, c2) = group.items()
        l1, l2 = _lift(c1), _lift(c2)
        # the "remainder" wire carries coefficient +-1
        if l2 in (1, -1):
            (w1, l1), (w2, l2) = (w2, l2), (w1, l1)
        if l1 not in (1, -1):
            return []
        if l2 is None or abs(l2) < 2:
            return []
        base = abs(l2)
        if base & (base - 1):
            # only power-of-two bases (circom's 2^64/2^128 carry splits) —
            # arbitrary bases would misfire on IsZero-style inverse rows
            return []
        # Mul128's `second === t_carry*2^128 + t` has integer targets up to
        # ~2^194 (64-bit limb products times 2^64); interpretations stay
        # unique because 2*2^194 << r.
        t = _lift(target)
        if t is None:
            v = target % R_MOD
            if v < (1 << 194):
                t = v
            elif R_MOD - v < (1 << 194):
                t = -(R_MOD - v)
            else:
                return []
        lo = (t * l1) % base  # s1*lo === T (mod base), lo in [0, base)
        hi_num = t - l1 * lo
        if hi_num % l2 != 0:
            return []
        hi = hi_num // l2
        # canonical hint splits have small quotients: limb splits have
        # hi < 2^64 and carry splits hi < ~2^66; anything larger is a
        # wrapped/noncanonical interpretation
        if hi < 0 or hi >= min(base, 1 << 66):
            return []
        for w, v in ((w1, lo), (w2, hi)):
            if w in binary and v not in (0, 1):
                return []
        values[w1] = lo % R_MOD
        values[w2] = hi % R_MOD
        return [w1, w2]

    def try_bit_group(group, target):
        """Solve a linear row over all-binary unknowns, by bound forcing or
        power-of-two decomposition.  Returns solved wires (possibly [])."""
        if not all(w in binary for w in group):
            return []
        if True:
            lifted = {}
            for w, coeff in group.items():
                lif = _lift(coeff)
                if lif is None or lif == 0:
                    return []
                lifted[w] = lif
            t = _lift(target)
            if t is None:
                return []
            # bound forcing: target at the achievable min/max forces every
            # bit (covers zero-sum constraints like circom's
            # `unsupported_selector_sum === 0`, any coefficient pattern)
            lo = sum(min(0, c) for c in lifted.values())
            hi = sum(max(0, c) for c in lifted.values())
            if t == lo:
                for w, c in lifted.items():
                    values[w] = 1 if c < 0 else 0
                return list(lifted)
            if t == hi:
                for w, c in lifted.items():
                    values[w] = 1 if c > 0 else 0
                return list(lifted)
            # power-of-two decomposition: same sign, distinct exponents
            exps = {}
            sign = None
            for w, lif in lifted.items():
                s = 1 if lif > 0 else -1
                mag = abs(lif)
                if mag & (mag - 1):
                    return []
                if sign is None:
                    sign = s
                elif s != sign:
                    return []
                e = mag.bit_length() - 1
                if e in exps:
                    return []
                exps[e] = w
            t = t if sign == 1 else -t
            if t < 0:
                return []
            solved = []
            for e, w in sorted(exps.items(), reverse=True):
                bit = 1 if (t >> e) & 1 else 0
                values[w] = bit
                t -= bit << e
                solved.append(w)
            if t != 0:
                for w in solved:
                    values[w] = None
                return []
            return solved
        return []

    def collect_rows():
        rows = []
        for i in sorted(pending):
            (a0, ua), (b0, ub), (c0, uc) = eval_sides(cons[i])
            if a0 == 0 and not ua:
                b0, ub = 0, {}
            elif b0 == 0 and not ub:
                a0, ua = 0, {}
            lr = _linear_row(a0, ua, b0, ub, c0, uc)
            if lr is not None and lr[0]:
                rows.append(lr)
        return rows

    def stall_divmod(banned: set) -> bool:
        """At a stall, apply ONE raw-row div-mod split with one-step
        lookahead: the unsafe-template splits are underconstrained, so only
        the raw row identifies the canonical (hint) assignment — but a row
        that is really a plain linear relation misfires, so propagate after
        applying and ban the row if that contradicts."""
        rows = collect_rows()
        # some splits span two rows through an alias wire (`inter1 =
        # in1[1]*2^64; in1_128 = inter1 + in1[0]`) — append the
        # Gaussian-reduced forms so those become visible
        pivots: dict = {}
        reduced = []
        for row, t in sorted(rows, key=lambda rt: len(rt[0])):
            row = dict(row)
            changed = True
            while changed:
                changed = False
                for w in list(row):
                    if w in pivots and w in row:
                        prow, pt = pivots[w]
                        f = row.pop(w)
                        for w2, c2 in prow.items():
                            if w2 == w:
                                continue
                            nv = (row.get(w2, 0) - f * c2) % R_MOD
                            if nv:
                                row[w2] = nv
                            else:
                                row.pop(w2, None)
                        t = (t - f * pt) % R_MOD
                        changed = True
            if not row:
                continue
            if len(row) == 2:
                reduced.append((row, t))
            # prefer +-1-coefficient (alias) wires as pivots so substitution
            # rebuilds the canonical `{lo: 1, hi: 2^64}` split rows
            pivot = next((w for w in row if _lift(row[w]) in (1, -1)), None)
            if pivot is None:
                pivot = next(iter(row))
            inv = pow(row[pivot], -1, R_MOD)
            pivots[pivot] = ({w: (c * inv) % R_MOD for w, c in row.items()},
                             (t * inv) % R_MOD)
        rows = rows + reduced
        # zero-target two-unknown rows are `y = c*x` relations (alias
        # wires), not hint splits: a (0,0) "split" there poisons the limb
        # values (and if (0,0) IS canonical, leaf zero-defaulting already
        # produces it) — skip them
        rows = [rt for rt in rows if rt[1] % R_MOD != 0]
        for row, t in rows:
            key = frozenset(row)
            if key in banned:
                continue
            if any(values[w] is not None for w in row):
                continue
            snap = snapshot()
            solved = try_divmod(row, t)
            if not solved:
                continue
            for w in solved:
                for j in by_wire[w]:
                    pending.add(j)
            if verbose:
                lifted = {w: _lift(c) for w, c in row.items()}
                print(f"[ws] divmod row={lifted} t={_lift(t)} "
                      f"-> { {w: values[w] for w in solved} }")
            try:
                propagate()
                return True
            except UnsolvableR1CS:
                if verbose:
                    print("[ws]   divmod contradicted; banned")
                restore(snap)
                banned.add(key)
        return False

    def linear_phase() -> bool:
        """Sparse Gaussian elimination over the currently-linear pending
        rows; returns True when any wire got solved."""
        rows = collect_rows()
        progress = False
        pivots: dict = {}  # wire -> (normalized row, target)
        rows.sort(key=lambda rt: len(rt[0]))
        for row, t in rows:
            row = dict(row)
            # substitute known pivots (repeat: substitution can introduce
            # new pivot wires)
            changed = True
            while changed:
                changed = False
                for w in list(row):
                    if w in pivots and w in row:
                        prow, pt = pivots[w]
                        f = row.pop(w)
                        for w2, c2 in prow.items():
                            if w2 == w:
                                continue
                            nv = (row.get(w2, 0) - f * c2) % R_MOD
                            if nv:
                                row[w2] = nv
                            else:
                                row.pop(w2, None)
                        t = (t - f * pt) % R_MOD
                        changed = True
            if not row:
                if t % R_MOD != 0:
                    raise UnsolvableR1CS("inconsistent linear system")
                continue
            if len(row) == 1:
                (w,) = row
                values[w] = (t * pow(row[w], -1, R_MOD)) % R_MOD
                progress = True
                for j in by_wire[w]:
                    pending.add(j)
                continue
            solved = try_bit_group(row, t)
            if solved:
                progress = True
                for w in solved:
                    for j in by_wire[w]:
                        pending.add(j)
                continue
            # choose a pivot: prefer a composite (non-binary) unknown so
            # bit-decomposition rows get disentangled
            pivot = next((w for w in row if w not in binary), None)
            if pivot is None:
                pivot = next(iter(row))
            inv = pow(row[pivot], -1, R_MOD)
            prow = {w: (c * inv) % R_MOD for w, c in row.items()}
            pivots[pivot] = (prow, (t * inv) % R_MOD)
        return progress

    def propagate():
        for _ in range(max_rounds):
            progress = False
            for i in sorted(pending):
                solved = try_constraint(i)
                if solved:
                    progress = True
                    for w in solved:
                        for j in by_wire[w]:
                            pending.add(j)
                else:
                    con = cons[i]
                    if all(values[w] is not None for w in con.wires):
                        pending.discard(i)
            if not progress:
                if linear_phase():
                    continue
                return

    def check_all() -> bool:
        for con in cons:
            (a0, ua), (b0, ub), (c0, uc) = eval_sides(con)
            if ua or ub or uc:
                return False
            if (a0 * b0 - c0) % R_MOD != 0:
                return False
        return True

    def snapshot():
        return list(values), set(binary), set(pending)

    def restore(snap):
        values[:], b, p = snap[0], snap[1], snap[2]
        binary.clear()
        binary.update(b)
        pending.clear()
        pending.update(p)

    budget = [64]  # total leaf attempts across all branches

    def branch_solve(depth: int) -> bool:
        propagate()
        banned: set = set()
        while stall_divmod(banned):
            pass
        # leaf attempt: zero-default the never-determined wires (circom
        # hint-wire semantics, e.g. IsZero's `inv` when in == 0)
        leaf = snapshot()
        for w in range(nwires):
            if values[w] is None:
                values[w] = 0
        budget[0] -= 1
        n_unk = sum(1 for w in leaf[0] if w is None)
        ok_leaf = check_all()
        if debug_state is not None and not ok_leaf:
            best = debug_state.get("best_leaf")
            if best is None or n_unk < best[0]:
                bad = []
                for bi, bcon in enumerate(cons):
                    (xa, xua), (xb, xub), (xc, xuc) = eval_sides(bcon)
                    if xua or xub or xuc or (xa * xb - xc) % R_MOD != 0:
                        bad.append(bi)
                debug_state["best_leaf"] = (n_unk, list(values),
                                            [w for w in range(nwires)
                                             if leaf[0][w] is None], bad)
        if verbose:
            print(f"[ws] leaf depth={depth} unk={n_unk} "
                  f"check={'OK' if ok_leaf else 'fail'} budget={budget[0]}")
        if ok_leaf:
            return True
        restore(leaf)
        if depth == 0 or budget[0] <= 0:
            return False
        # Some hint wires are genuinely ambiguous at the R1CS level — e.g.
        # getSignAndAbs256_unsafe's isNeg (`qap-compiler/templates/256bit/
        # two_complement_unsafe.circom:8-21`) admits both (0, in) and
        # (1, 2^256-in).  Branch on the stalled binary wire with the most
        # pending constraints (mux-selector-shaped) and keep any completion
        # that satisfies the full system.
        cand = {}
        for i in pending:
            (a0, ua), (b0, ub), (c0, uc) = eval_sides(cons[i])
            # only wires on a *product* side discriminate (mux selectors,
            # isNeg) — decomposition bits appear linearly and branching
            # them resolves nothing
            for w in set(ua) | set(ub):
                # skip the wire's own binarity row `w*(w-1) = 0`
                if w in binary and not cons[i].wires <= {0, w}:
                    cand[w] = cand.get(w, 0) + 1
        if not cand:
            return False
        w = max(sorted(cand), key=lambda k: cand[k])
        if verbose:
            print(f"[ws] branch depth={depth} wire={w} (pending uses "
                  f"{cand[w]}, {len(cand)} candidates)")
        for v in (0, 1):
            snap = snapshot()
            values[w] = v
            for j in by_wire[w]:
                pending.add(j)
            try:
                if branch_solve(depth - 1):
                    return True
            except UnsolvableR1CS:
                pass
            restore(snap)
        return False

    try:
        ok = branch_solve(depth=8)
    finally:
        if debug_state is not None:
            debug_state.update(values=list(values), binary=set(binary),
                               pending=set(pending), cons=cons)

    if not ok:
        raise UnsolvableR1CS(
            "propagation stalled or no branch completion satisfies the "
            "constraint system"
        )
    return [int(v) for v in values]
