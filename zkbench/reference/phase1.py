"""The plain reference that judges the close of phase 1, in Python integers:
a chain of phase-1 updates, each checked by the coordinator, and the CRS
the coordinator prepares from the last accepted accumulator.

It knows each job's contributor seed and beacon seed, because the benchmark
drew them from the run's seed, and takes nothing the program made but the
answers it judges: each job's verdict, its two Schnorr proofs, the
accumulator the coordinator loaded at the sampled indices, and the prepared
CRS at the sampled points.

* The secrets.  A contribution draws alpha_u, x_u and then the two Schnorr
  nonces (alpha's, then x's) from its stream, each as the program documents
  `_rand_fr` (`ceremony.rand_fr`).  `pok_fail` counts the proofs (tags
  `tzk/p1/alpha`, `tzk/p1/x`) whose X_g1 is not u G1, X_g2 not u G2 or R not
  k G1.
* The accumulator.  The chain starts at upstream's `phase1_initialize`,
  x = alpha = 1 (every power the generator).  A contribution on the
  accumulator of (x, alpha) makes that of (x', alpha') = (x x_u, alpha
  alpha_u): x_g1[h] = x'^(h+1) G1 for h < max(2n, 2m_i) - 1, alpha_g1[k] =
  alpha'^(k+1) G1 and alpha_g2[k] = alpha'^(k+1) G2 for k < 4,
  alpha_x_g1[k][h] = alpha'^(k+1) x'^(h+1) G1 for h < max(n, m_i) + 2,
  x_g2 = x' G2, and its contributor index is one more.  `mismatch` counts
  every sampled point, and the index, that breaks this.
* The prepared CRS.  `generate_sigma`'s at (x, y, alpha) with gamma = delta
  = eta = 1, x and alpha those of the last accepted accumulator (the job's
  own once the coordinator accepts it) and y the job's beacon, worked out
  at the sampled points by `ceremony.Ceremony.base()`.  `mismatch` counts
  the points that differ.
* `rejected` counts the jobs the coordinator refused; a refused update does
  not enter the chain.
"""

from __future__ import annotations

import numpy as np

from . import curve as C
from . import g2 as G2
from .ceremony import Ceremony, differing, rand_fr
from .curve import R

N_ALPHA = 4
SECRETS = ("alpha", "x")


def acc_sizes(params: dict) -> tuple[int, int]:
    """(powers of x_g1, powers of each alpha_x_g1 row) at a `setupParams.json`."""
    n, m_i = params["n"], params["l_D"] - params["l"]
    return max(2 * n, 2 * m_i) - 1, max(n, m_i) + 2


def sample_indices(params: dict, per_row: int, rng: np.random.Generator) -> dict:
    """`per_row` distinct indices of x_g1 and of each alpha_x_g1 row, sorted."""
    x_len, ax_len = acc_sizes(params)

    def draw(size):
        return sorted(int(i) for i in rng.choice(size, size=min(per_row, size), replace=False))

    return dict(x_g1=draw(x_len), alpha_x_g1=[draw(ax_len) for _ in range(N_ALPHA)])


def beacon(seed: int) -> int:
    """The public beacon y of a job's beacon seed."""
    return rand_fr(np.random.default_rng(seed))


def secrets(contributor_seed: int) -> dict:
    """alpha_u, x_u and the two Schnorr nonces of one contribution."""
    rng = np.random.default_rng(contributor_seed)
    u = {k: rand_fr(rng) for k in SECRETS}
    return dict(u=u, k={k: rand_fr(rng) for k in SECRETS})


class Phase1:
    """The judge of one run: the library and the sampled indices of the
    accumulator (`acc_index`) and of the prepared CRS (`crs_index`)."""

    def __init__(self, lib, acc_index: dict, crs_index: dict):
        self.lib, self.acc_index, self.crs_index = lib, acc_index, crs_index

    def accumulator(self, x: int, alpha: int, index: int) -> dict:
        """The accumulator of (x, alpha) at the sampled indices."""
        a = [pow(alpha, k + 1, R) for k in range(N_ALPHA)]
        return dict(
            index=index,
            x_g1=[C.mul(C.G1_GEN, pow(x, h + 1, R)) for h in self.acc_index["x_g1"]],
            alpha_x_g1=[[C.mul(C.G1_GEN, a[k] * pow(x, h + 1, R)) for h in row]
                        for k, row in enumerate(self.acc_index["alpha_x_g1"])],
            alpha_g1=[C.mul(C.G1_GEN, v) for v in a],
            alpha_g2=[G2.mul(G2.G2_GEN, v) for v in a],
            x_g2=G2.mul(G2.G2_GEN, x))

    def crs(self, x: int, y: int, alpha: int) -> dict:
        """The prepared CRS of (x, y, alpha) at the sampled points."""
        tau = dict(x=x, y=y, alpha=alpha, gamma=1, delta=1, eta=1)
        return Ceremony(self.lib, tau, self.crs_index).base()

    def judge(self, chain: list) -> dict:
        """`chain`: (contributor seed, beacon seed, answer) of every completed
        job, in the order they ran -> the counts, and `detail`: what failed
        where."""
        flags = dict(rejected=0, pok_fail=0, mismatch=0)
        detail = []
        x = alpha = 1
        accepted = 0
        for n, (seed, beacon_seed, ans) in enumerate(chain):
            s = secrets(seed)
            pok = self.pok_fails(s, ans["pok"])
            if pok:
                detail.append((n, "proof of knowledge", pok))
            x_new, a_new = x * s["u"]["x"] % R, alpha * s["u"]["alpha"] % R
            bad = acc_differing(ans["acc"], self.accumulator(x_new, a_new, accepted + 1))
            if bad:
                detail.append((n, "accumulator", bad[:4]))
            if ans["accepted"]:
                x, alpha, accepted = x_new, a_new, accepted + 1
            else:
                flags["rejected"] += 1
            wrong = differing(ans["crs"], self.crs(x, beacon(beacon_seed), alpha))
            if wrong:
                detail.append((n, "prepared CRS", wrong[:4]))
            flags["pok_fail"] += len(pok)
            flags["mismatch"] += len(bad) + len(wrong)
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


def acc_differing(a: dict, b: dict) -> list:
    """The entries of two accumulator samples that differ, by name."""
    out = [("index",)] if a["index"] != b["index"] else []
    for key in ("x_g1", "alpha_g1", "alpha_g2"):
        out += [(key, i) for i, (p, q) in enumerate(zip(a[key], b[key])) if p != q]
        if len(a[key]) != len(b[key]):
            out.append((key, "count"))
    for k, (ra, rb) in enumerate(zip(a["alpha_x_g1"], b["alpha_x_g1"])):
        out += [("alpha_x_g1", k, i) for i, (p, q) in enumerate(zip(ra, rb)) if p != q]
        if len(ra) != len(rb):
            out.append(("alpha_x_g1", k, "count"))
    if len(a["alpha_x_g1"]) != len(b["alpha_x_g1"]):
        out.append(("alpha_x_g1", "count"))
    if a["x_g2"] != b["x_g2"]:
        out.append(("x_g2",))
    return out
