"""Scalable synthetic fixture at (or near) the reference workload shape.

Generates a parameterized circuit family with the same *shape* profile as the
shipped subcircuit library (n=4096, s_max=256, m_i=4096,
m_D≈26.6k, ~234 placements, ~658k placement variables): public IO buffers plus
"chain" subcircuits whose constraints form a multiplication chain, wired
placement-to-placement through copy constraints.  Values are generated by
forward evaluation so every protocol invariant holds — this is the
framework's equivalent of `PlacementVariables::gen_dummy`
(`libs/src/field_structures/mod.rs:169-202`), upgraded to satisfy the
constraints so that proofs actually verify.

Performance is shape-driven (polynomial grids, NTT domains, MSM sizes are
functions of n/s_max/m_i/m_D only), so benchmarks on this fixture are
representative of the real library at the same SetupParams.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fields import R_MOD
from ..models.protocol import (
    Instance, PermutationEntry, Placement, SetupParams, SubcircuitInfo,
    SubcircuitR1CS,
)
from .fixtures import Fixture

# SHA-256 of `canonical_proof_bytes` of the JAX package's proof of
# `build_synthetic()` at its defaults, under `Tau.fixed()` and `Mixer.zero()`
# (its native CPU backend, ~7 min); `tests/test_torch_fullshape_golden.py`
# recomputes it, and `chip_smoke.py` holds the port's proof on the card to it.
FULLSHAPE_PROOF_SHA256 = "8de4bf3d9aa94bc1f7f6dce12c285999810eec0014f88959c70803cf44a275e7"


def build_synthetic(
    n: int = 4096,
    s_max: int = 256,
    m_i: int = 4096,
    n_synth_kinds: int = 6,
    priv_per_synth: int = 2700,
    seed: int = 0,
) -> Fixture:
    rng = np.random.default_rng(seed)

    def rand_fr():
        return int.from_bytes(rng.bytes(32), "little") % R_MOD

    # --- shape bookkeeping -------------------------------------------
    l_user_out = max(2, m_i // 64)
    l = l_free = l_user = 2 * l_user_out
    n_pub_out = l_user_out
    n_pub_in = l - n_pub_out
    # interface budget: buffers take (1 + n_pub) each; synth kinds split rest
    iface_budget = m_i - (1 + n_pub_out) - (1 + n_pub_in)
    per_synth_iface = iface_budget // n_synth_kinds
    n_out = min(per_synth_iface // 2 - 1, 255)
    n_in = n_out + 1
    assert 1 + n_out + n_in <= per_synth_iface
    n_priv = min(priv_per_synth, n - n_out - 1)

    l_D = l + m_i
    m_D = l_D + n_synth_kinds * n_priv
    params = SetupParams(
        l_free=l_free, l=l, l_user_out=l_user_out, l_user=l_user,
        l_D=l_D, m_D=m_D, n=n, s_D=2 + n_synth_kinds, s_max=s_max,
    )
    params.validate()
    neg1 = (-1) % R_MOD

    # --- global wire layout ------------------------------------------
    # publics: [0, n_pub_out) pubOut outs; [n_pub_out, l) pubIn ins
    g = l  # next interface global
    infos: list[SubcircuitInfo] = []
    library: list[SubcircuitR1CS] = []

    # bufferPubOut: [const, out*n_pub_out (public), in*n_pub_out (interface)]
    fm = [g] + list(range(0, n_pub_out)) + list(range(g + 1, g + 1 + n_pub_out))
    g += 1 + n_pub_out
    infos.append(
        SubcircuitInfo(0, "bufferPubOut", 1 + 2 * n_pub_out,
                       (1, n_pub_out), (1 + n_pub_out, n_pub_out), fm)
    )
    library.append(
        SubcircuitR1CS(
            A_cols={
                **{1 + j: [(j, 1)] for j in range(n_pub_out)},
                **{1 + n_pub_out + j: [(j, neg1)] for j in range(n_pub_out)},
            },
            B_cols={0: [(j, 1) for j in range(n_pub_out)]},
            C_cols={},
        )
    )

    # bufferPubIn: [const, out*n_pub_in (interface), in*n_pub_in (public)]
    fm = [g] + list(range(g + 1, g + 1 + n_pub_in)) + list(range(n_pub_out, l))
    g += 1 + n_pub_in
    infos.append(
        SubcircuitInfo(1, "bufferPubIn", 1 + 2 * n_pub_in,
                       (1, n_pub_in), (1 + n_pub_in, n_pub_in), fm)
    )
    library.append(
        SubcircuitR1CS(
            A_cols={
                **{1 + j: [(j, 1)] for j in range(n_pub_in)},
                **{1 + n_pub_in + j: [(j, neg1)] for j in range(n_pub_in)},
            },
            B_cols={0: [(j, 1) for j in range(n_pub_in)]},
            C_cols={},
        )
    )

    # synth kinds: [const, out*n_out, in*n_in, priv*n_priv]
    g_priv = l_D
    for kind in range(n_synth_kinds):
        nw = 1 + n_out + n_in + n_priv
        fm = (
            [g]
            + list(range(g + 1, g + 1 + n_out + n_in))
            + list(range(g_priv, g_priv + n_priv))
        )
        g += 1 + n_out + n_in
        g_priv += n_priv
        infos.append(
            SubcircuitInfo(2 + kind, f"synth{kind}", nw,
                           (1, n_out), (1 + n_out, n_in), fm)
        )
        A_cols: dict = {}
        B_cols: dict = {0: []}
        C_cols: dict = {}
        W_CONST, W_OUT0, W_IN0 = 0, 1, 1 + n_out
        W_PRIV0 = 1 + n_out + n_in

        def add(cols, wire, k, c=1):
            cols.setdefault(wire, []).append((k, c))

        # chain constraints: priv[0] = in0*in1; priv[t] = priv[t-1]*in[t%n_in]
        for t in range(n_priv):
            if t == 0:
                add(A_cols, W_IN0, 0)
                add(B_cols, W_IN0 + 1, 0)
            else:
                add(A_cols, W_PRIV0 + t - 1, t)
                add(B_cols, W_IN0 + (t % n_in), t)
            add(C_cols, W_PRIV0 + t, t)
        # out binding: out[j] = priv[n_priv-1-j] * const
        for j in range(n_out):
            k = n_priv + j
            add(A_cols, W_PRIV0 + (n_priv - 1 - j), k)
            add(B_cols, W_CONST, k)
            add(C_cols, W_OUT0 + j, k)
        library.append(SubcircuitR1CS(A_cols=A_cols, B_cols=B_cols, C_cols=C_cols))

    # --- placements + forward evaluation ------------------------------
    a_pub_in = [rand_fr() for _ in range(n_pub_in)]
    placements: list[Placement] = [None, None]  # buffers filled at the end
    # producers[(placement, local_out_idx)] value; copy edges for permutation
    copy_groups: dict[tuple[int, int], list[tuple[int, int]]] = {}
    # key: producer grid position (interface row, col); values: member list

    def grid_pos(pl_idx: int, info: SubcircuitInfo, local_wire: int):
        return (info.flattenMap[local_wire] - l, pl_idx)

    prev_outs = None  # (values, positions) of the previous producer
    pubin_info = infos[1]
    pubin_out_vals = list(a_pub_in)
    pubin_out_pos = [grid_pos(1, pubin_info, 1 + j) for j in range(n_pub_in)]

    for i in range(2, s_max):
        kind = (i - 2) % n_synth_kinds
        info = infos[2 + kind]
        r1cs = library[2 + kind]
        if prev_outs is None:
            src_vals, src_pos = pubin_out_vals, pubin_out_pos
        else:
            src_vals, src_pos = prev_outs
        ins, in_pos = [], []
        for j in range(n_in):
            s = j % len(src_vals)
            ins.append(src_vals[s])
            in_pos.append(src_pos[s])
        # forward-evaluate the chain
        priv = [0] * n_priv
        priv[0] = ins[0] * ins[1] % R_MOD
        for t in range(1, n_priv):
            priv[t] = priv[t - 1] * ins[t % n_in] % R_MOD
        outs = [priv[n_priv - 1 - j] for j in range(n_out)]
        variables = [1] + outs + ins + priv
        placements.append(Placement(2 + kind, variables))
        # copy bookkeeping: this placement's in j is a copy of src
        for j in range(n_in):
            key = in_pos[j]
            copy_groups.setdefault(key, []).append(grid_pos(i, info, 1 + n_out + j))
        prev_outs = (outs, [grid_pos(i, info, 1 + j) for j in range(n_out)])

    # bufferPubOut consumes the last producer's first n_pub_out outs
    last_vals, last_pos = prev_outs
    a_pub_out = [last_vals[j % len(last_vals)] for j in range(n_pub_out)]
    pubout_info = infos[0]
    pubout_vars = [1] + a_pub_out + a_pub_out
    placements[0] = Placement(0, pubout_vars)
    for j in range(n_pub_out):
        key = last_pos[j % len(last_pos)]
        copy_groups.setdefault(key, []).append(
            grid_pos(0, pubout_info, 1 + n_pub_out + j)
        )
    # bufferPubIn
    pubin_vars = [1] + list(a_pub_in) + list(a_pub_in)
    placements[1] = Placement(1, pubin_vars)

    # --- permutation cycles -------------------------------------------
    permutation: list[PermutationEntry] = []
    for producer, consumers in copy_groups.items():
        cyc = [producer] + consumers
        k = len(cyc)
        for t in range(k):
            row, col = cyc[t]
            nrow, ncol = cyc[(t + 1) % k]
            permutation.append(PermutationEntry(row=row, col=col, X=nrow, Y=ncol))

    instance = Instance(
        a_pub_user=a_pub_out + a_pub_in, a_pub_block=[], a_pub_function=[]
    )
    return Fixture(
        params=params, library=library, infos=infos, placements=placements,
        permutation=permutation, instance=instance,
    )
