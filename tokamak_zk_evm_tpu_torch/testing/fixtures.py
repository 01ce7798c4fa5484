"""Synthetic end-to-end fixture: a tiny but fully consistent circuit.

Plays the role of the reference's pinned ERC20 synthesizer fixtures +
`PlacementVariables::gen_dummy` : a miniature subcircuit
library (two public buffers + a multiplier), placements, witness values,
permutation cycles, and public instance that satisfy every protocol
invariant — arithmetic constraints, copy constraints, and the binding
identity — so setup -> preprocess -> prove -> verify can run end-to-end at
toy sizes.

Layout (mirrors the real library's buffer conventions,
`group_structures/mod.rs:184-300`):
  globals [0, l)        public wires: bufferPubOut outs, bufferPubIn ins
  globals [l, l_D)      interface wires (const wires, buffer inner sides,
                        mul2 out/in wires)
  globals [l_D, m_D)    private wires (mul2 internals)
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import R_MOD
from ..models.protocol import (
    Instance, PermutationEntry, Placement, SetupParams, SubcircuitInfo,
    SubcircuitR1CS,
)

N = 8
S_MAX = 4
L = 4

# SHA-256 of `io.artifacts.canonical_proof_bytes` of the proof of
# `build_fixture()` under `Tau.fixed()` and `Mixer.zero()`: the digest the JAX
# package pins for the same inputs, which the port must reproduce.
GOLDEN_PROOF_SHA256 = "1e12b801f425aef040d3957a95f391e65212c044586b93ad1a90495daeccf4ca"


@dataclass
class Fixture:
    params: SetupParams
    library: list[SubcircuitR1CS]
    infos: list[SubcircuitInfo]
    placements: list[Placement]
    permutation: list[PermutationEntry]
    instance: Instance


def _col(n, entries):
    return [(k, v % R_MOD) for k, v in entries]


def build_fixture() -> Fixture:
    params = SetupParams(
        l_free=4, l=4, l_user_out=2, l_user=4, l_D=20, m_D=22, n=N, s_D=3, s_max=S_MAX
    )
    neg1 = (-1) % R_MOD

    # subcircuit 0: bufferPubOut — wires [const, out1, out2, in1, in2],
    # constraints out_i - in_i = 0 (times the const wire)
    buf_out = SubcircuitR1CS(
        A_cols={
            1: _col(N, [(0, 1)]), 3: _col(N, [(0, neg1)]),
            2: _col(N, [(1, 1)]), 4: _col(N, [(1, neg1)]),
        },
        B_cols={0: _col(N, [(0, 1), (1, 1)])},
        C_cols={},
    )
    info0 = SubcircuitInfo(
        id=0, name="bufferPubOut", Nwires=5, Out_idx=(1, 2), In_idx=(3, 2),
        flattenMap=[4, 0, 1, 5, 6],
    )

    # subcircuit 1: bufferPubIn — wires [const, out1, out2, in1, in2]
    buf_in = SubcircuitR1CS(
        A_cols={
            1: _col(N, [(0, 1)]), 3: _col(N, [(0, neg1)]),
            2: _col(N, [(1, 1)]), 4: _col(N, [(1, neg1)]),
        },
        B_cols={0: _col(N, [(0, 1), (1, 1)])},
        C_cols={},
    )
    info1 = SubcircuitInfo(
        id=1, name="bufferPubIn", Nwires=5, Out_idx=(1, 2), In_idx=(3, 2),
        flattenMap=[7, 8, 9, 2, 3],
    )

    # subcircuit 2: mul2 — wires [const, out, in1, in2, w4, w5]
    #   k0: in1 * in2 = w4;  k1: w4 * in1 = out;  k2: w4 * w4 = w5
    mul2 = SubcircuitR1CS(
        A_cols={2: _col(N, [(0, 1)]), 4: _col(N, [(1, 1), (2, 1)])},
        B_cols={3: _col(N, [(0, 1)]), 2: _col(N, [(1, 1)]), 4: _col(N, [(2, 1)])},
        C_cols={4: _col(N, [(0, 1)]), 1: _col(N, [(1, 1)]), 5: _col(N, [(2, 1)])},
    )
    info2 = SubcircuitInfo(
        id=2, name="mul2", Nwires=6, Out_idx=(1, 1), In_idx=(2, 2),
        flattenMap=[10, 11, 12, 13, 20, 21],
    )

    # witness values
    v_in1, v_in2 = 3, 5
    out_p2 = v_in1 * v_in1 * v_in2          # 45  = (in1*in2)*in1
    out_p3 = (out_p2 * v_in2) * out_p2      # w4=out_p2*v_in2 ... recompute below
    w4_p2 = v_in1 * v_in2                   # 15
    w5_p2 = w4_p2 * w4_p2                   # 225
    w4_p3 = out_p2 * v_in2                  # 225
    out_p3 = w4_p3 * out_p2                 # 10125
    w5_p3 = w4_p3 * w4_p3

    placements = [
        Placement(0, [1, out_p2, out_p3, out_p2, out_p3]),       # bufferPubOut
        Placement(1, [1, v_in1, v_in2, v_in1, v_in2]),           # bufferPubIn
        Placement(2, [1, out_p2, v_in1, v_in2, w4_p2, w5_p2]),   # mul2 #1
        Placement(2, [1, out_p3, out_p2, v_in2, w4_p3, w5_p3]),  # mul2 #2
    ]

    # copy cycles over interface wires (row = global - l, col = placement)
    cycles = [
        [(8, 1), (12, 2)],            # pubIn.out1 -> mul#1.in1
        [(9, 1), (13, 2), (13, 3)],   # pubIn.out2 -> mul#1.in2 -> mul#2.in2
        [(11, 2), (12, 3), (5, 0)],   # mul#1.out -> mul#2.in1 -> pubOut.in1
        [(11, 3), (6, 0)],            # mul#2.out -> pubOut.in2
    ]
    permutation = []
    l = params.l
    for cyc in cycles:
        k = len(cyc)
        for t, (g, col) in enumerate(cyc):
            ng, ncol = cyc[(t + 1) % k]
            permutation.append(
                PermutationEntry(row=g - l, col=col, X=ng - l, Y=ncol)
            )

    instance = Instance(
        a_pub_user=[out_p2, out_p3, v_in1, v_in2],
        a_pub_block=[],
        a_pub_function=[],
    )
    return Fixture(
        params=params,
        library=[buf_out, buf_in, mul2],
        infos=[info0, info1, info2],
        placements=placements,
        permutation=permutation,
        instance=instance,
    )
