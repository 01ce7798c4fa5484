"""The plain reference that judges each proof, in Python integers and NumPy.

It knows the trapdoor tau, because the benchmark drew it from the seed, and
works out again from the library, the job and tau everything it needs; it
takes nothing the program made but the proof it judges.

* The verification relation.  Every G2 element of the verifier's pairing
  check (`verify-rust/src/lib.rs:248-289`) is a known multiple of the G2
  generator (alpha^k, gamma, eta, delta, x, y), so the pairing equation
  holds exactly when one G1 combination of the proof's points and the
  statement's points is the identity.  The statement's points (the
  permutation polynomials s0, s1, the fixed public part, the copy Lagrange
  term) are known multiples of G as well.  The challenges come from this
  package's own transcript; kappa2, the verifier's batching challenge, is
  drawn from the seed.
* The witness encoding and the blinding.  With the mixer known, U, V, W, B,
  O_mid, O_prv and V_eval are computed outright from the job's variables and
  compared.  A_free and O_pub_free carry no blinding and are computed in
  every case.  A proof whose U or V_eval equals the unblinded value carries
  no zero-knowledge blinding.
"""

from __future__ import annotations

import numpy as np

from . import curve as C
from .curve import R
from .transcript import challenges


def _obj(vals) -> np.ndarray:
    return np.asarray([int(v) % R for v in vals], dtype=object)


def _dot(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.dot(a, b)) % R if len(a) else 0


def _col_evals(cols: dict, basis: list, nwires: int) -> list:
    """sum_k coeff * basis[k] for every wire's column."""
    out = [0] * nwires
    for wire, col in cols.items():
        acc = 0
        for k, c in col:
            acc += c * basis[k]
        out[wire] = acc % R
    return out


class Reference:
    """The statement's side of the check for one library and one tau."""

    def __init__(self, lib, tau: dict):
        p = self.p = dict(lib.params, m_i=lib.params["l_D"] - lib.params["l"])
        self.lib = lib
        self.tau = tau
        x, y, al = tau["x"], tau["y"], tau["alpha"]
        n, s_max, m_i, l, l_d = p["n"], p["s_max"], p["m_i"], p["l"], p["l_D"]
        self.Kn = C.lagrange_at(x, n)
        self.Kmi = self.Kn if m_i == n else C.lagrange_at(x, m_i)
        self.Ly = C.lagrange_at(y, s_max)
        self.Ml = C.lagrange_at(x, p["l_free"])
        a2, a3 = al * al % R, pow(al, 3, R)
        self.a4 = pow(al, 4, R)

        # per-kind QAP evaluations at x and the global o vector
        # (`Sigma::gen`, `compute_o_vec`: a later kind overwrites a wire)
        o_vec = [0] * p["m_D"]
        self.kinds = []
        for info, (A, B, Cc) in zip(lib.infos, lib.r1cs):
            nw = info["Nwires"]
            u = _col_evals(A, self.Kn, nw)
            v = _col_evals(B, self.Kn, nw)
            w = _col_evals(Cc, self.Kn, nw)
            for j, g in enumerate(info["flattenMap"]):
                o = (al * u[j] + a2 * v[j] + a3 * w[j]) % R
                if o:
                    o_vec[g] = o
            self.kinds.append((u, v, w))
        self.o_vec = o_vec

        # gamma^-1 (L_k(y) o_j + M_j(x)) for the public wires
        m_block = p["l_free"] - p["l_user"]
        user = ([self.Ly[0]] * p["l_user_out"] + [self.Ly[1]] * (p["l_user"] - p["l_user_out"])
                + [self.Ly[2]] * m_block + [self.Ly[3]] * (l - p["l_free"]))
        g_inv = pow(tau["gamma"], -1, R)
        self.gi = [((user[j] * o_vec[j] + (self.Ml[j] if j < p["l_free"] else 0)) * g_inv) % R
                   for j in range(l)]
        e_inv = pow(tau["eta"], -1, R)
        d_inv = pow(tau["delta"], -1, R)

        # per kind: the wires each sum reads, and their coefficients at x
        self.per_kind = []
        for info, (u, v, w) in zip(lib.infos, self.kinds):
            fm = np.asarray(info["flattenMap"], dtype=np.int64)
            iface = np.nonzero((fm >= l) & (fm < l_d))[0]
            prv = np.nonzero(fm >= l_d)[0]
            nz = {k: np.nonzero(np.asarray([c != 0 for c in arr]))[0]
                  for k, arr in (("u", u), ("v", v), ("w", w))}
            self.per_kind.append(dict(
                u=(nz["u"], _obj([u[j] for j in nz["u"]])),
                v=(nz["v"], _obj([v[j] for j in nz["v"]])),
                w=(nz["w"], _obj([w[j] for j in nz["w"]])),
                b=(iface, _obj([self.Kmi[fm[j] - l] for j in iface])),
                mid=(iface, _obj([e_inv * (o_vec[fm[j]] + self.a4 * self.Kmi[fm[j] - l])
                                  for j in iface])),
                prv=(prv, _obj([d_inv * o_vec[fm[j]] for j in prv])),
            ))
        self.t_x = (pow(x, n, R) - 1) % R
        self.t_mi_x = (pow(x, m_i, R) - 1) % R
        self.t_y = (pow(y, s_max, R) - 1) % R
        self.kl = self.Ly[s_max - 1] * self.Kmi[m_i - 1] % R
        self.w_mi = C.omega(m_i)
        self.w_s = C.omega(s_max)

    # -- the job's own scalars ------------------------------------------
    def witness(self, job) -> dict:
        """u, v, w, b at (x, y), and the binding cores, as scalars of G."""
        sums = dict(u=0, v=0, w=0, b=0, mid=0, prv=0)
        for col, (sid, variables) in enumerate(job.placements):
            var = np.asarray(variables, dtype=object)
            ly = self.Ly[col]
            for key, (idx, coef) in self.per_kind[sid].items():
                sums[key] = (sums[key] + ly * _dot(var[idx], coef)) % R
        return sums

    def statement(self, job) -> dict:
        p, tau = self.p, self.tau
        l = p["l"]
        # O_pub_free: the buffers' public wires against gamma_inv_o_inst
        opf = 0
        for sid, variables in job.placements:
            info = self.lib.infos[sid]
            if info["name"] == "bufferPubOut":
                start, cnt = info["Out_idx"]
            elif info["name"] in ("bufferPubIn", "bufferBlockIn"):
                start, cnt = info["In_idx"]
            else:
                continue
            for j in range(start, start + cnt):
                opf += variables[j] * self.gi[info["flattenMap"][j]]
        m_block = p["l_free"] - p["l_user"]
        a = [v % R for v in job.a_pub_user[:p["l_user"]]] + \
            [v % R for v in job.a_pub_block[:m_block]]
        if len(a) != p["l_free"]:
            raise ValueError("instance length does not match l_free")
        a_free = sum(ai * mi for ai, mi in zip(a, self.Ml)) % R
        m_fn = l - p["l_free"]
        fix = sum(v * self.gi[l - m_fn + j] for j, v in enumerate(job.a_pub_function)) % R
        # s0, s1 at (x, y): X and Y, moved where the permutation moves a wire
        moved = {(r, c): (X, Y) for r, c, X, Y in job.permutation}
        s0, s1 = tau["x"], tau["y"]
        m_i, s_max = p["m_i"], p["s_max"]
        for (r, c), (X, Y) in moved.items():
            k = self.Kmi[r] * self.Ly[c] % R
            s0 += (pow(self.w_mi, X, R) - pow(self.w_mi, r, R)) * k
            s1 += (pow(self.w_s, Y, R) - pow(self.w_s, c, R)) * k
        return dict(O_pub_free=opf % R, a=a, A_free=a_free, O_pub_fix=fix,
                    s0=s0 % R, s1=s1 % R)

    def v_at(self, job, chi: int, zeta: int) -> int:
        """v(chi, zeta) of the unblinded witness polynomial."""
        kn = C.lagrange_at(chi, self.p["n"])
        lz = C.lagrange_at(zeta, self.p["s_max"])
        per_kind = {}
        acc = 0
        for col, (sid, variables) in enumerate(job.placements):
            if sid not in per_kind:
                vb = _col_evals(self.lib.r1cs[sid][1], kn, self.lib.infos[sid]["Nwires"])
                idx = np.nonzero(np.asarray([c != 0 for c in vb]))[0]
                per_kind[sid] = (idx, _obj([vb[j] for j in idx]))
            idx, coef = per_kind[sid]
            acc += lz[col] * _dot(np.asarray(variables, dtype=object)[idx], coef)
        return acc % R

    # -- the judgement ----------------------------------------------------
    def judge(self, job, proof: dict, mixer: dict | None, kappa2: int) -> dict:
        """Flags of one proof: relation_fail, unblinded, mismatch (0 or 1
        each) and the names of what differed."""
        bad_points = [k for k, v in proof.items()
                      if isinstance(v, tuple) and not (C.on_curve(v) and C.in_subgroup(v))]
        if bad_points:
            return dict(relation_fail=1, unblinded=0, mismatch=1, detail=bad_points)
        st = self.statement(job)
        wit = self.witness(job)
        ch = challenges(proof)
        rel = self._relation(proof, st, ch, kappa2)
        v_plain = self.v_at(job, ch["chi"], ch["zeta"])
        G = C.G1_GEN
        u_plain_pt = C.mul(G, wit["u"])
        unblinded = int(proof["U"] == u_plain_pt or proof["V_eval"] == v_plain)
        expect = dict(A_free=st["A_free"], O_pub_free=st["O_pub_free"])
        if mixer is not None:
            expect.update(self._blinded(wit, mixer))
        diff = [k for k, s in expect.items() if proof[k] != C.mul(G, s)]
        if mixer is not None:
            t_n = (pow(ch["chi"], self.p["n"], R) - 1) % R
            t_s = (pow(ch["zeta"], self.p["s_max"], R) - 1) % R
            if proof["V_eval"] != (v_plain + mixer["rV_X"] * t_n + mixer["rV_Y"] * t_s) % R:
                diff.append("V_eval")
        return dict(relation_fail=int(not rel), unblinded=unblinded,
                    mismatch=int(bool(diff)), detail=diff)

    def _blinded(self, wit: dict, m: dict) -> dict:
        """U, V, W, B, O_mid, O_prv as scalars of G under mixer `m`
        (`prove0`, `_compute_binding`)."""
        x, y = self.tau["x"], self.tau["y"]
        tx, tmi, ty = self.t_x, self.t_mi_x, self.t_y

        def low(c, z):
            return sum(ci * pow(z, i, R) for i, ci in enumerate(c)) % R

        d_inv = pow(self.tau["delta"], -1, R)
        al = self.tau["alpha"]
        a = [pow(al, k, R) for k in range(5)]
        zk = (a[1] * tx * m["rU_X"] + a[2] * tx * m["rV_X"] + a[3] * tx * low(m["rW_X"][:3], x)
              + a[4] * tmi * low(m["rB_X"], x)
              + a[1] * ty * m["rU_Y"] + a[2] * ty * m["rV_Y"] + a[3] * ty * low(m["rW_Y"][:3], y)
              + a[4] * ty * low(m["rB_Y"], y)) * d_inv
        return dict(
            U=wit["u"] + m["rU_X"] * tx + m["rU_Y"] * ty,
            V=wit["v"] + m["rV_X"] * tx + m["rV_Y"] * ty,
            W=wit["w"] + low(m["rW_X"], x) * tx + low(m["rW_Y"], y) * ty,
            B=wit["b"] + low(m["rB_X"], x) * tmi + low(m["rB_Y"], y) * ty,
            O_mid=wit["mid"] + m["rO_mid"] * self.tau["delta"],
            O_prv=wit["prv"] - m["rO_mid"] * self.tau["eta"] + zk,
        )

    def _relation(self, pf: dict, st: dict, ch: dict, k2: int) -> bool:
        p, tau = self.p, self.tau
        th, k0, chi, zeta, k1 = ch["thetas"], ch["kappa0"], ch["chi"], ch["zeta"], ch["kappa1"]
        t_n = (pow(chi, p["n"], R) - 1) % R
        t_mi = (pow(chi, p["m_i"], R) - 1) % R
        t_s = (pow(zeta, p["s_max"], R) - 1) % R
        k0_eval = 1 if chi == 1 else t_mi * pow(p["m_i"], -1, R) * pow(chi - 1, -1, R) % R
        a_eval = sum(ai * mi for ai, mi in
                     zip(st["a"], C.lagrange_at(chi, p["l_free"]))) % R
        re, rx, rxy, ve = pf["R_eval"], pf["R_omegaX_eval"], pf["R_omegaX_omegaY_eval"], pf["V_eval"]
        c = {}
        g = 0

        def add(name, k):
            c[name] = (c.get(name, 0) + k) % R

        # kappa2 * lhs_arith
        for name, k in (("U", ve), ("W", -1), ("V", k1), ("Q_AX", -t_n), ("Q_AY", -t_s)):
            add(name, k2 * k)
        g -= k2 * k1 * ve
        # kappa2 * lhs_copy; F = B + th0 s0 + th1 s1 + th2, Gt = B + th0 x + th1 y + th2
        f_s = th[0] * st["s0"] + th[1] * st["s1"] + th[2]
        g_s = th[0] * tau["x"] + th[1] * tau["y"] + th[2]
        c1 = k0 * (chi - 1) % R
        c2 = k0 * k0 % R * k0_eval % R
        k1_2, k1_3 = k1 * k1 % R, pow(k1, 3, R)
        add("B", k2 * k1_2 * (re * c1 - rx * c1 + re * c2 - rxy * c2))
        g += k2 * k1_2 * ((re - 1) * self.kl + (re * c1 + re * c2) * g_s
                          - (rx * c1 + rxy * c2) * f_s)
        add("Q_CX", -k2 * k1_2 * t_mi)
        add("Q_CY", -k2 * k1_2 * t_s)
        add("R", k2 * (k1_3 + k2 + k2 * k2))
        g -= k2 * (k1_3 * re + k2 * rx + k2 * k2 * rxy)
        # lhs_binding
        kb = k2 * pow(k1, 4, R) % R
        add("A_free", 1 + kb)
        g -= kb * a_eval
        # AUX and the G2 sides: alpha^4 B + alpha U + alpha^2 V + alpha^3 W
        # - gamma O_pub - eta O_mid - delta O_prv - x AUX_X - y AUX_Y
        wmi_inv = pow(self.w_mi, -1, R)
        ws_inv = pow(self.w_s, -1, R)
        k2_2, k2_3 = k2 * k2 % R, pow(k2, 3, R)
        x, y = tau["x"], tau["y"]
        add("Pi_X", k2 * chi - x * k2)
        add("Pi_Y", k2 * zeta - y * k2)
        add("M_X", k2_2 * wmi_inv * chi - x * k2_2)
        add("M_Y", k2_2 * zeta - y * k2_2)
        add("N_X", k2_3 * wmi_inv * chi - x * k2_3)
        add("N_Y", k2_3 * ws_inv * zeta - y * k2_3)
        al = tau["alpha"]
        for name, k in (("B", pow(al, 4, R)), ("U", al), ("V", al * al), ("W", pow(al, 3, R)),
                        ("O_pub_free", -tau["gamma"]), ("O_mid", -tau["eta"]),
                        ("O_prv", -tau["delta"])):
            add(name, k)
        g -= tau["gamma"] * st["O_pub_fix"]
        terms = [(pf[name], k) for name, k in c.items()] + [(C.G1_GEN, g % R)]
        return C.lincomb(terms) is None
