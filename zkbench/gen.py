"""Seeded inputs: the chain-family library, tau, jobs and mixers, as plain data.

The chain family of `tokamak_zk_evm_tpu_torch/testing/synthetic.py` (public
IO buffers plus "chain" subcircuits whose constraints form a multiplication
chain, wired placement to placement through copy constraints), rebuilt to
any published `setupParams.json`: the four public buffers of the shipped
library at its public wire layout, and chain kinds that fill its interface
and private wire counts.  One library serves many jobs: each job takes its
own placement count and its own random public inputs, and every value
follows by forward evaluation, so each job's R1CS and copy constraints hold.

Everything here is plain Python and NumPy.  `entries/` converts it into the
program's types; `reference/` reads it as it is.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

R_MOD = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of one seed; any whole number is a seed."""
    return np.random.default_rng([seed & (2**64 - 1), *stream])


def rand_fr(rng: np.random.Generator) -> int:
    return int.from_bytes(rng.bytes(32), "little") % R_MOD


@dataclass
class Library:
    """Setup parameters, subcircuit infos and sparse R1CS columns.

    `infos[i]`: dict with id, name, Nwires, Out_idx, In_idx, flattenMap.
    `r1cs[i]`: (A, B, C), each a dict wire -> [(constraint, coeff)].
    Kinds 0-3 are the public buffers; chain kind `BUFFERS + c` carries
    `n_priv[c]` private wires, the first (c = 0) the most."""

    params: dict
    infos: list
    r1cs: list
    n_out: int
    n_in: int
    n_priv: list


@dataclass
class Job:
    """One transaction: placements (subcircuit id, variables), the copy
    permutation as (row, col, X, Y) and the public instance."""

    index: int
    n_placements: int
    placements: list
    permutation: list
    a_pub_user: list
    a_pub_block: list = field(default_factory=list)
    a_pub_function: list = field(default_factory=list)
    mixer: dict | None = None


BUFFERS = 4  # bufferPubOut, bufferPubIn, bufferBlockIn, bufferEVMIn, in columns 0-3


def _buffer(kind: int, name: str, g: int, lo: int, hi: int, out_public: bool):
    """A buffer of `hi - lo` wires whose outputs equal its inputs; the public
    side maps to [lo, hi), the other side to interface wires from `g` on."""
    cnt = hi - lo
    iface = list(range(g + 1, g + 1 + cnt))
    pub = list(range(lo, hi))
    fm = [g] + (pub + iface if out_public else iface + pub)
    info = dict(id=kind, name=name, Nwires=1 + 2 * cnt, Out_idx=(1, cnt),
                In_idx=(1 + cnt, cnt), flattenMap=fm)
    r1cs = ({**{1 + j: [(j, 1)] for j in range(cnt)},
             **{1 + cnt + j: [(j, R_MOD - 1)] for j in range(cnt)}},
            {0: [(j, 1) for j in range(cnt)]},
            {})
    return info, r1cs


def make_library(l: int, l_D: int, l_free: int, l_user: int, l_user_out: int, m_D: int,
                 n: int, s_D: int, s_max: int) -> Library:
    """A library whose `setupParams.json` is exactly these numbers.

    The public wires [0, l) are laid out as the shipped library lays them
    out: bufferPubOut's outputs [0, l_user_out), bufferPubIn's inputs
    [l_user_out, l_user), bufferBlockIn's [l_user, l_free), bufferEVMIn's
    [l_free, l).  The other s_D - 4 kinds are chain subcircuits, which share
    the m_i = l_D - l interface wires left after the buffers' and the
    m_D - l_D private wires: the first takes as many as n constraints allow,
    the rest split what remains."""
    params = dict(l=l, l_D=l_D, l_free=l_free, l_user=l_user, l_user_out=l_user_out,
                  m_D=m_D, n=n, s_D=s_D, s_max=s_max)
    m_i, n_kinds = l_D - l, s_D - BUFFERS
    if not 0 < l_user_out < l_user < l_free < l or n_kinds < 1:
        raise ValueError("the public wires need four non-empty parts and a chain kind")
    per_kind = (m_i - (BUFFERS + l)) // n_kinds
    n_out = (per_kind - 2) // 2
    n_in = n_out + 1
    heavy = n - n_out - 1
    rest = m_D - l_D - heavy
    light = [] if n_kinds == 1 else [rest // (n_kinds - 1) + (c < rest % (n_kinds - 1))
                                     for c in range(n_kinds - 1)]
    n_priv = [heavy] + light
    if n_out < 1 or (n_kinds == 1 and rest != 0) or \
            not all(max(2, n_out) <= p <= heavy for p in n_priv):
        raise ValueError(f"no chain family fits {params}")

    infos, r1cs = [], []
    g = l
    for kind, (name, lo, hi, out_public) in enumerate((
            ("bufferPubOut", 0, l_user_out, True), ("bufferPubIn", l_user_out, l_user, False),
            ("bufferBlockIn", l_user, l_free, False), ("bufferEVMIn", l_free, l, False))):
        info, cols = _buffer(kind, name, g, lo, hi, out_public)
        g += 1 + (hi - lo)
        infos.append(info)
        r1cs.append(cols)

    g_priv = l_D
    w_out0, w_in0, w_priv0 = 1, 1 + n_out, 1 + n_out + n_in
    for c, np_ in enumerate(n_priv):
        fm = ([g] + list(range(g + 1, g + 1 + n_out + n_in))
              + list(range(g_priv, g_priv + np_)))
        g += 1 + n_out + n_in
        g_priv += np_
        infos.append(dict(id=BUFFERS + c, name=f"chain{c}", Nwires=1 + n_out + n_in + np_,
                          Out_idx=(1, n_out), In_idx=(1 + n_out, n_in), flattenMap=fm))
        a, b, cc = {}, {0: []}, {}

        def add(cols, wire, k):
            cols.setdefault(wire, []).append((k, 1))

        # priv[0] = in0 * in1; priv[t] = priv[t-1] * in[t % n_in]
        for t in range(np_):
            if t == 0:
                add(a, w_in0, 0)
                add(b, w_in0 + 1, 0)
            else:
                add(a, w_priv0 + t - 1, t)
                add(b, w_in0 + (t % n_in), t)
            add(cc, w_priv0 + t, t)
        # out[j] = priv[np_ - 1 - j] * const
        for j in range(n_out):
            k = np_ + j
            add(a, w_priv0 + (np_ - 1 - j), k)
            add(b, 0, k)
            add(cc, w_out0 + j, k)
        r1cs.append((a, b, cc))
    assert g <= l_D and g_priv == m_D
    return Library(params=params, infos=infos, r1cs=r1cs, n_out=n_out, n_in=n_in,
                   n_priv=n_priv)


def chain_kinds(lib: Library, n_chain: int, heavy: tuple) -> list[int]:
    """The chain kind of each chain placement: `heavy` = (a, b) puts the
    first kind at a of every b positions, spread evenly; the others take
    the remaining positions in turn."""
    a, b = heavy
    n_light = len(lib.n_priv) - 1
    kinds, lights = [], 0
    for i in range(n_chain):
        if n_light == 0 or (i * a) % b < a:
            kinds.append(0)
        else:
            kinds.append(1 + lights % n_light)
            lights += 1
    return kinds


def make_job(lib: Library, n_placements: int, rng: np.random.Generator, index: int = 0,
             heavy: tuple = (1, 2)) -> Job:
    """A job of `n_placements` placements: the four buffers and chain
    subcircuits.  The first chain placements read the public inputs (user,
    block and function), each later one its predecessor's outputs; the
    last one's outputs are the public outputs."""
    p = lib.params
    l, l_user_out, l_user, l_free = p["l"], p["l_user_out"], p["l_user"], p["l_free"]
    n_chain = n_placements - BUFFERS
    if not 1 <= n_chain <= p["s_max"] - BUFFERS:
        raise ValueError(f"{n_placements} placements do not fit s_max={p['s_max']}")
    n_out, n_in = lib.n_out, lib.n_in
    infos = lib.infos

    def pos(col, info, local):
        return (info["flattenMap"][local] - l, col)

    a_pub_in = [rand_fr(rng) for _ in range(l_user - l_user_out)]
    a_block = [rand_fr(rng) for _ in range(l_free - l_user)]
    a_function = [rand_fr(rng) for _ in range(l - l_free)]
    placements: list = [None] * BUFFERS
    pool_vals, pool_pos = [], []
    for col, vals in ((1, a_pub_in), (2, a_block), (3, a_function)):
        placements[col] = (col, [1] + vals + vals)
        pool_vals += vals
        pool_pos += [pos(col, infos[col], 1 + j) for j in range(len(vals))]
    n_pool = -(-len(pool_vals) // n_in)  # chain placements that read the public inputs

    copy_groups: dict = {}
    src_vals, src_pos = [], []
    for c, kind in enumerate(chain_kinds(lib, n_chain, heavy)):
        col = BUFFERS + c
        info = infos[BUFFERS + kind]
        if c < n_pool:
            take = [(c * n_in + j) % len(pool_vals) for j in range(n_in)]
            ins_src = [(pool_vals[t], pool_pos[t]) for t in take]
        else:
            ins_src = [(src_vals[j % n_out], src_pos[j % n_out]) for j in range(n_in)]
        ins = [v for v, _ in ins_src]
        np_ = lib.n_priv[kind]
        priv = [0] * np_
        acc = ins[0] * ins[1] % R_MOD
        priv[0] = acc
        for t in range(1, np_):
            acc = acc * ins[t % n_in] % R_MOD
            priv[t] = acc
        outs = [priv[np_ - 1 - j] for j in range(n_out)]
        placements.append((BUFFERS + kind, [1] + outs + ins + priv))
        for j, (_, producer) in enumerate(ins_src):
            copy_groups.setdefault(producer, []).append(pos(col, info, 1 + n_out + j))
        src_vals = outs
        src_pos = [pos(col, info, 1 + j) for j in range(n_out)]

    a_pub_out = [src_vals[j % n_out] for j in range(l_user_out)]
    placements[0] = (0, [1] + a_pub_out + a_pub_out)
    for j in range(l_user_out):
        copy_groups.setdefault(src_pos[j % n_out], []).append(
            pos(0, infos[0], 1 + l_user_out + j))

    permutation = []
    for producer, consumers in copy_groups.items():
        cyc = [producer] + consumers
        k = len(cyc)
        for t in range(k):
            row, col = cyc[t]
            nrow, ncol = cyc[(t + 1) % k]
            permutation.append((row, col, nrow, ncol))
    return Job(index=index, n_placements=n_placements, placements=placements,
               permutation=permutation, a_pub_user=a_pub_out + a_pub_in,
               a_pub_block=a_block, a_pub_function=a_function)


def make_tau(rng: np.random.Generator) -> dict:
    return {k: rand_fr(rng) for k in ("x", "y", "alpha", "gamma", "delta", "eta")}


def make_mixer(rng: np.random.Generator) -> dict:
    """The field order of the program's `Mixer` (rW_* pad their fourth entry
    with 0)."""
    r = lambda: rand_fr(rng)  # noqa: E731
    return dict(rU_X=r(), rU_Y=r(), rV_X=r(), rV_Y=r(),
                rW_X=[r(), r(), r(), 0], rW_Y=[r(), r(), r(), 0],
                rB_X=[r(), r()], rB_Y=[r(), r()], rR_X=r(), rR_Y=r(), rO_mid=r())


def zero_mixer() -> dict:
    return dict(rU_X=0, rU_Y=0, rV_X=0, rV_Y=0, rW_X=[0, 0, 0, 0], rW_Y=[0, 0, 0, 0],
                rB_X=[0, 0], rB_Y=[0, 0], rR_X=0, rR_Y=0, rO_mid=0)


def placement_count(traffic: dict, i: int) -> int:
    """Placements of job `i`, the buffers included, the same for every seed.

    The mix's range [lo, hi] is taken in pairs mirrored about its middle,
    (mid - d, mid + d), with d running through 0 .. (hi - lo) / 2 in a fixed
    shuffled order: every two jobs average the middle, and the sizes cover
    the range evenly."""
    lo, hi = traffic["placements"]
    if (hi - lo) % 2:
        raise ValueError("a mix's placement range needs an even width")
    ds = np.random.default_rng(0).permutation((hi - lo) // 2 + 1)
    d = int(ds[(i // 2) % len(ds)])
    return (lo + hi) // 2 + (d if i % 2 else -d)


def job(lib: Library, n_placements: int, seed: int, i: int, with_mixer: bool,
        heavy: tuple) -> Job:
    """Job `i` of a seed: its own stream for the inputs, then the mixer."""
    rng = rng_for(seed, 2, i)
    out = make_job(lib, n_placements, rng, index=i, heavy=heavy)
    if with_mixer:
        out.mixer = make_mixer(rng)
    return out
