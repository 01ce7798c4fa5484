"""The plain reference that judges a chain of phase-2 contributions, in
Python integers.

It knows the trapdoor tau and each job's contributor seed, because the
benchmark drew both from the run's seed, and takes nothing the program made
but the answers it judges: each job's verdict, its three Schnorr proofs,
and the CRS before and after the contribution at the sampled points.

* The starting CRS.  `base()` works out the CRS that `generate_sigma` makes
  from tau (`models/setup.py`'s layout, the scalars of `check.Reference`) at
  the sampled points: 16 a family of `xy_powers`, `gamma_inv_o_inst`,
  `eta_inv_li_o_inter_alpha4_kj` and `delta_inv_li_o_prv`, and every host
  point.  Job 0's CRS before must equal it, so the chain is anchored.
* The secrets.  A contribution draws gamma, delta, eta and then the three
  Schnorr nonces from its stream, each as the program documents `_rand_fr`:
  32 bytes, little-endian, mod r, drawn again while 0.  `pok_fail` counts
  the proofs whose X_g1 is not u G1, X_g2 not u G2 or R not k G1.
* The contribution.  `mismatch` counts the points that break a rule: each
  sampled point of a rescaled family is u^-1 times its point before (gamma
  for `gamma_inv_o_inst`, eta for `eta_inv_...`, delta for
  `delta_inv_li_o_prv` and the 23 delta-inverse host points); `sigma_1`'s
  delta and eta are u times theirs, and so are `sigma_2`'s gamma, delta and
  eta; `xy_powers` and every other point are unchanged; and a job's CRS
  before equals the CRS after the last job the coordinator accepted.
* `rejected` counts the jobs the coordinator refused.
"""

from __future__ import annotations

import numpy as np

from . import curve as C
from . import g2 as G2
from .check import Reference
from .curve import R

FAMILIES = ("xy_powers", "gamma_inv_o_inst", "eta_inv_li_o_inter_alpha4_kj",
            "delta_inv_li_o_prv")
RESCALED = {"gamma_inv_o_inst": "gamma", "eta_inv_li_o_inter_alpha4_kj": "eta",
            "delta_inv_li_o_prv": "delta"}
HOST_G1 = ("G", "x", "y", "delta", "eta", "lagrange_KL")
G2_POINTS = ("H", "alpha", "alpha2", "alpha3", "alpha4", "gamma", "delta", "eta", "x", "y")
SECRETS = ("gamma", "delta", "eta")


def family_sizes(params: dict) -> dict:
    """Points of each device family at a `setupParams.json`."""
    m_i = params["l_D"] - params["l"]
    return dict(xy_powers=max(2 * params["n"], 2 * m_i) * 2 * params["s_max"],
                gamma_inv_o_inst=params["l"],
                eta_inv_li_o_inter_alpha4_kj=m_i * params["s_max"],
                delta_inv_li_o_prv=(params["m_D"] - params["l_D"]) * params["s_max"])


def sample_indices(params: dict, per_family: int, rng: np.random.Generator) -> dict:
    """`per_family` distinct indices of each family, sorted."""
    out = {}
    for name, size in family_sizes(params).items():
        k = min(per_family, size)
        out[name] = sorted(int(i) for i in rng.choice(size, size=k, replace=False))
    return out


def rand_fr(rng) -> int:
    v = 0
    while v == 0:
        v = int.from_bytes(rng.bytes(32), "little") % R
    return v


def secrets(contributor_seed: int) -> dict:
    """gamma, delta, eta and the three Schnorr nonces of one contribution."""
    rng = np.random.default_rng(contributor_seed)
    u = {k: rand_fr(rng) for k in SECRETS}
    return dict(u=u, k={k: rand_fr(rng) for k in SECRETS})


class Ceremony:
    """The judge of one run: the library, tau and the sampled indices."""

    def __init__(self, lib, tau: dict, index: dict):
        self.lib, self.tau, self.index = lib, tau, index

    def base(self) -> dict:
        """The starting CRS at the sampled points, from tau."""
        ref = Reference(self.lib, self.tau)
        p, tau = ref.p, self.tau
        x, y, al = tau["x"], tau["y"], tau["alpha"]
        s_max, l, l_d, m_i = p["s_max"], p["l"], p["l_D"], p["m_i"]
        rs_y = 2 * s_max
        e_inv, d_inv = pow(tau["eta"], -1, R), pow(tau["delta"], -1, R)

        def xy(k):
            return pow(x, k // rs_y, R) * pow(y, k % rs_y, R) % R

        def inter(k):
            j, i = divmod(k, s_max)
            return e_inv * (ref.o_vec[l + j] + ref.a4 * ref.Kmi[j]) % R * ref.Ly[i] % R

        def prv(k):
            j, i = divmod(k, s_max)
            return d_inv * ref.o_vec[l_d + j] % R * ref.Ly[i] % R

        scalar = dict(xy_powers=xy, gamma_inv_o_inst=lambda k: ref.gi[k],
                      eta_inv_li_o_inter_alpha4_kj=inter, delta_inv_li_o_prv=prv)
        families = {name: [C.mul(C.G1_GEN, scalar[name](k)) for k in self.index[name]]
                    for name in FAMILIES}
        small = ([d_inv * pow(al, k, R) * pow(x, h, R) * ref.t_x for k in (1, 2, 3)
                  for h in range(3)]
                 + [d_inv * ref.a4 * pow(x, j, R) * ref.t_mi_x for j in range(2)]
                 + [d_inv * pow(al, k, R) * pow(y, i, R) * ref.t_y for k in (1, 2, 3, 4)
                    for i in range(3)])
        g1 = dict(G=1, x=x, y=y, delta=tau["delta"], eta=tau["eta"], lagrange_KL=ref.kl)
        g2 = dict(H=1, alpha=al, alpha2=al * al, alpha3=pow(al, 3, R), alpha4=ref.a4,
                  gamma=tau["gamma"], delta=tau["delta"], eta=tau["eta"], x=x, y=y)
        return dict(families=families, small=[C.mul(C.G1_GEN, s) for s in small],
                    g1={k: C.mul(C.G1_GEN, v) for k, v in g1.items()},
                    g2={k: G2.mul(G2.G2_GEN, v) for k, v in g2.items()})

    def judge(self, chain: list) -> dict:
        """`chain`: (contributor seed, answer) of every completed job, in the
        order they ran -> the counts, and `detail`: what failed where."""
        flags = dict(rejected=0, pok_fail=0, mismatch=0)
        detail = []
        last = self.base()
        for n, (seed, ans) in enumerate(chain):
            bad = differing(ans["prev"], last)
            if bad:
                detail.append((n, "prev is not the last accepted CRS", bad[:4]))
            s = secrets(seed)
            pok = self.pok_fails(s, ans["pok"])
            if pok:
                detail.append((n, "proof of knowledge", pok))
            wrong = contribution_errors(s["u"], ans["prev"], ans["cur"])
            if wrong:
                detail.append((n, "contribution", wrong[:4]))
            flags["pok_fail"] += len(pok)
            flags["mismatch"] += len(bad) + len(wrong)
            if ans["accepted"]:
                last = ans["cur"]
            else:
                flags["rejected"] += 1
        flags["detail"] = detail
        return flags

    @staticmethod
    def pok_fails(s: dict, pok: dict) -> list:
        out = []
        for name in SECRETS:
            u, k, pf = s["u"][name], s["k"][name], pok[name]
            if (pf["X_g1"], pf["R"], pf["X_g2"]) != (C.mul(C.G1_GEN, u), C.mul(C.G1_GEN, k),
                                                      G2.mul(G2.G2_GEN, u)):
                out.append(name)
        return out


def differing(a: dict, b: dict) -> list:
    """The points of two CRS samples that differ, by name."""
    out = []
    for name in FAMILIES:
        out += [(name, i) for i, (p, q) in enumerate(zip(a["families"][name],
                                                       b["families"][name])) if p != q]
        if len(a["families"][name]) != len(b["families"][name]):
            out.append((name, "count"))
    out += [("small", i) for i, (p, q) in enumerate(zip(a["small"], b["small"])) if p != q]
    if len(a["small"]) != len(b["small"]):
        out.append(("small", "count"))
    for key in ("g1", "g2"):
        out += [(key, k) for k in b[key] if a[key].get(k) != b[key][k]]
    return out


def contribution_errors(u: dict, prev: dict, cur: dict) -> list:
    """The sampled points of `cur` that are not `prev` rescaled by u."""
    inv = {k: pow(v, -1, R) for k, v in u.items()}
    out = []
    for name in FAMILIES:
        k = inv[RESCALED[name]] if name in RESCALED else 1
        for i, (p, q) in enumerate(zip(prev["families"][name], cur["families"][name])):
            if q != (p if k == 1 else C.mul(p, k)):
                out.append((name, i))
        if len(prev["families"][name]) != len(cur["families"][name]):
            out.append((name, "count"))
    for i, (p, q) in enumerate(zip(prev["small"], cur["small"])):
        if q != C.mul(p, inv["delta"]):
            out.append(("small", i))
    if len(prev["small"]) != len(cur["small"]):
        out.append(("small", "count"))
    for key in HOST_G1:
        k = u[key] if key in ("delta", "eta") else 1
        want = prev["g1"][key] if k == 1 else C.mul(prev["g1"][key], k)
        if cur["g1"].get(key) != want:
            out.append(("g1", key))
    for key in G2_POINTS:
        k = u[key] if key in SECRETS else 1
        want = prev["g2"][key] if k == 1 else G2.mul(prev["g2"][key], k)
        if cur["g2"].get(key) != want:
            out.append(("g2", key))
    return out
