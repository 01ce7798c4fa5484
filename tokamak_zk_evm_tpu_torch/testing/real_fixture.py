"""Fixture over the REAL shipped subcircuit library.

Loads the reference's compiled library (`packages/frontend/qap-compiler/
subcircuits/library`: 14 circom subcircuits as binary R1CS) and constructs a
buffer-only placement set whose witnesses are computable in closed form —
each buffer constrains out_i == in_i (`subcircuits/circom/buffers.circom`
semantics, verified against the parsed R1CS in the JAX package's tests).
This exercises the full protocol against the real circuit shapes
(n=4096, m_i=4096, l=728, m_D=26591) without the TS synthesizer.

The port's copy of the JAX package's module.  One difference: the JAX
module defaults `library_dir` to an absolute path into a checkout of the
reference; here `library_dir=None` resolves at call time through
`io/subcircuit_library.resolve_library_path` (the CLI's chain: the
TZK_SUBCIRCUIT_LIBRARY environment variable, then a library embedded in
the package).

Wire map of the public region [0, l) (from `subcircuitInfo.json` flattenMap):
  [0, 65)    bufferPubOut outs  -> a_pub_user[:l_user_out]
  [65, 85)   bufferPubIn  ins   -> a_pub_user[l_user_out:l_user]
  [85, 109)  bufferBlockIn ins  -> a_pub_block (padded to l_free - l_user)
  [109, 128) (unused by the shipped library; zero)
  [128, 728) bufferEVMIn  ins   -> a_pub_function (fixed instance, l - l_free)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from ..fields import R_MOD
from ..io.artifacts import load_library
from ..io.subcircuit_library import resolve_library_path
from ..models.protocol import (
    Instance, PermutationEntry, Placement, SetupParams, SubcircuitInfo,
    SubcircuitR1CS,
)

@dataclass
class RealFixture:
    params: SetupParams
    library: list[SubcircuitR1CS]
    infos: list[SubcircuitInfo]
    placements: list[Placement]
    permutation: list[PermutationEntry]
    instance: Instance


def _buffer_placement(info: SubcircuitInfo, io_vals: list[int]) -> Placement:
    """[const=1] + outs + ins with outs == ins == io_vals."""
    o0, oc = info.Out_idx
    i0, ic = info.In_idx
    assert oc == ic == len(io_vals)
    vars_ = [0] * info.Nwires
    vars_[0] = 1
    for j, v in enumerate(io_vals):
        vars_[o0 + j] = v % R_MOD
        vars_[i0 + j] = v % R_MOD
    return Placement(subcircuit_id=info.id, variables=vars_)


def _dectobit_placement(info: SubcircuitInfo, lo: int, hi: int) -> Placement:
    """DecToBit witness built in closed form: wires are
    [const] + out[256] (bit decomposition) + in[2] (lower/upper 128-bit limbs)
    (`qap-compiler/subcircuits/circom/DecToBit_circuit.circom`: out[i] =
    bit i of in[0], out[i+128] = bit i of in[1]; no internal wires)."""
    assert 0 <= lo < (1 << 128) and 0 <= hi < (1 << 128)
    o0, oc = info.Out_idx
    i0, ic = info.In_idx
    assert oc == 256 and ic == 2 and info.Nwires == 259
    vars_ = [0] * info.Nwires
    vars_[0] = 1
    vars_[i0] = lo
    vars_[i0 + 1] = hi
    for b in range(128):
        vars_[o0 + b] = (lo >> b) & 1
        vars_[o0 + 128 + b] = (hi >> b) & 1
    return Placement(subcircuit_id=info.id, variables=vars_)


def check_r1cs_satisfaction(r1cs: SubcircuitR1CS, variables: list[int]) -> bool:
    """Host-exact R1CS check: (A w) * (B w) == (C w) per constraint row
    (the reference's testing-mode equivalent, `prove/src/lib.rs:1473-1518`,
    evaluated directly on the sparse columns instead of QAP evals)."""
    from collections import defaultdict

    sums = []
    for cols in (r1cs.A_cols, r1cs.B_cols, r1cs.C_cols):
        acc: dict[int, int] = defaultdict(int)
        for wire, col in cols.items():
            v = variables[wire] % R_MOD
            if v:
                for k, coeff in col:
                    acc[k] = (acc[k] + coeff * v) % R_MOD
        sums.append(acc)
    a, b, c = sums
    for k in set(a) | set(b) | set(c):
        if (a.get(k, 0) * b.get(k, 0)) % R_MOD != c.get(k, 0) % R_MOD:
            return False
    return True


ALU1_SELECTORS = {
    # selector bit -> EVM op (templates/256bit/alu_safe.circom:110-136)
    1: "ADD", 2: "MUL", 3: "SUB", 16: "LT", 17: "GT", 20: "EQ",
    21: "ISZERO", 22: "AND", 23: "OR", 24: "XOR", 25: "NOT",
}

L128 = (1 << 128) - 1


def build_real_tx_fixture(
    library_dir: str | None = None,
    s_max: int = 64,
    seed: int = 17,
) -> RealFixture:
    """Transaction-shaped fixture: `s_max` placements on the real library with
    exact WASM witnesses and a cross-placement copy web.

    Mirrors the reference's synthesized workload structure (234 placements /
    658k variables for the canonical ERC20 transfer,
    `packages/backend-wasm/README.md:468`): the four public buffers feed a
    chain of ALU1 ops whose outputs thread through ALU2 (div group), DecToBit,
    Poseidon, and Accumulator placements; every value handoff is a genuine
    copy-constraint cycle on the interface grid, exactly how the synthesizer's
    permutation links placement wires (`core/src/app/synthesize.ts:31`).
    Witnesses come from the shipped circom WASM calculators run natively
    (frontend/witness_calculator.py), so semantics are bit-exact.

    `library_dir=None` resolves through `resolve_library_path` at call time
    (the JAX package defaults to a path into a reference checkout).
    """
    from ..frontend.witness_calculator import SubcircuitCalculators

    library_dir = resolve_library_path(library_dir)
    params, infos, library = load_library(library_dir)
    assert s_max >= 16 and (s_max & (s_max - 1)) == 0
    params = dataclasses.replace(params, s_max=s_max)
    calcs = SubcircuitCalculators(library_dir)

    rng_state = seed
    def rand128():
        nonlocal rng_state
        rng_state = (rng_state * 6364136223846793005 + 1442695040888963407) % (1 << 64)
        return (rng_state * 0x9E3779B97F4A7C15 + (rng_state >> 3)) & L128

    by_name = {i.name: i for i in infos}
    pub_out_i = by_name["bufferPubOut"]
    pub_in_i = by_name["bufferPubIn"]
    block_in_i = by_name["bufferBlockIn"]
    evm_in_i = by_name["bufferEVMIn"]
    alu1_i, alu2_i = by_name["ALU1"], by_name["ALU2"]
    dec_i, pos_i, acc_i = by_name["DecToBit"], by_name["Poseidon"], by_name["Accumulator"]

    l = params.l
    # copy web: list of cycles, each a list of (row, col) interface cells that
    # must hold equal values; emitted as PermutationEntry links at the end
    cycles: list[list[tuple[int, int]]] = []
    placements: list[Placement] = []

    def cell(info, local_wire, col):
        row = info.flattenMap[local_wire] - l
        assert 0 <= row < params.l_D - l, (info.name, local_wire, row)
        return (row, col)

    # --- public buffers (placements 0-3), wired as in build_real_fixture ---
    pub_in_vals = [rand128() for _ in range(pub_in_i.In_idx[1])]
    block_vals = [rand128() for _ in range(block_in_i.In_idx[1])]
    evm_vals = [rand128() for _ in range(evm_in_i.In_idx[1])]
    n_out = pub_out_i.Out_idx[1]
    out_vals = [pub_in_vals[j % len(pub_in_vals)] for j in range(n_out)]
    placements.append(_buffer_placement(pub_out_i, out_vals))
    placements.append(_buffer_placement(pub_in_i, pub_in_vals))
    placements.append(_buffer_placement(block_in_i, block_vals))
    placements.append(_buffer_placement(evm_in_i, evm_vals))
    n_in = len(pub_in_vals)
    pubin_cycles = []
    for j in range(n_in):
        cyc = [cell(pub_in_i, pub_in_i.Out_idx[0] + j, 1)]
        for k in range(j, n_out, n_in):
            cyc.append(cell(pub_out_i, pub_out_i.In_idx[0] + k, 0))
        pubin_cycles.append(cyc)
    cycles.extend(pubin_cycles)

    def wasm_placement(info, ins):
        w = calcs.witness(info.id, ins)
        assert check_r1cs_satisfaction(library[info.id], w), info.name
        placements.append(Placement(subcircuit_id=info.id, variables=w))
        return w, len(placements) - 1

    # --- ALU1 value chain: v <- v OP b, each output copied into the next
    # placement's first operand ---
    sel_bits = sorted(ALU1_SELECTORS)
    budget = s_max - len(placements)
    n_alu2 = max(1, budget // 8)
    n_dec = max(1, budget // 16)
    n_pos = max(1, budget // 16)
    n_acc = max(1, budget // 16)
    n_alu1 = budget - n_alu2 - n_dec - n_pos - n_acc
    v_lo, v_hi = pub_in_vals[0], 0
    # Each ALU1 output limb owns ONE growable cycle (producer cell first);
    # the chain's next-in1 and any ALU2/DecToBit/Poseidon/Accumulator
    # consumers append to it — a cell may appear in exactly one cycle.
    prev_cycles = None  # (cyc_lo, cyc_hi) of the previous chain placement
    alu_outs: list[tuple[int, int, int]] = []  # (alu index, out_lo, out_hi)
    out_cycles: list[tuple[list, list]] = []   # per ALU1: its out-limb cycles
    o0 = alu1_i.Out_idx[0]
    for k in range(n_alu1):
        sel = sel_bits[k % len(sel_bits)]
        b_lo, b_hi = rand128(), rand128()
        ins = [1 << sel, v_lo, v_hi, b_lo, b_hi]
        w, col = wasm_placement(alu1_i, ins)
        in1_lo, in1_hi = cell(alu1_i, 4, col), cell(alu1_i, 5, col)
        if prev_cycles is None:
            pubin_cycles[0].append(in1_lo)  # seed: pubIn.out[0] == in1_lo
        else:
            prev_cycles[0].append(in1_lo)
            prev_cycles[1].append(in1_hi)
        v_lo, v_hi = w[o0], w[o0 + 1]
        cyc_lo = [cell(alu1_i, o0, col)]
        cyc_hi = [cell(alu1_i, o0 + 1, col)]
        cycles.append(cyc_lo)
        cycles.append(cyc_hi)
        prev_cycles = (cyc_lo, cyc_hi)
        alu_outs.append((k, w[o0], w[o0 + 1]))
        out_cycles.append((cyc_lo, cyc_hi))

    def link_pair(src_alu, dst_cells):
        """Copy ALU1 #src_alu's (out_lo, out_hi) into consumer cells."""
        out_cycles[src_alu][0].append(dst_cells[0])
        out_cycles[src_alu][1].append(dst_cells[1])

    # --- ALU2 (div group) consumers: in1 copies an ALU1 output ---
    for k in range(n_alu2):
        src_alu, s_lo, s_hi = alu_outs[(3 * k) % (len(alu_outs) - 1)]
        d = rand128() | 1
        ins = [1 << (4 + (k % 3)), s_lo, s_hi, d, 0, 0, 0]  # DIV/SDIV/MOD
        w, col = wasm_placement(alu2_i, ins)
        link_pair(src_alu, (cell(alu2_i, 4, col), cell(alu2_i, 5, col)))

    # --- DecToBit consumers: both limbs copy an ALU1 output ---
    for k in range(n_dec):
        src_alu, s_lo, s_hi = alu_outs[(5 * k + 1) % (len(alu_outs) - 1)]
        w, col = wasm_placement(dec_i, [s_lo, s_hi])
        i0 = dec_i.In_idx[0]
        link_pair(src_alu, (cell(dec_i, i0, col), cell(dec_i, i0 + 1, col)))

    # --- Poseidon consumers: first bus word copies an ALU1 output ---
    for k in range(n_pos):
        src_alu, s_lo, s_hi = alu_outs[(7 * k + 2) % (len(alu_outs) - 1)]
        ins = [1, s_lo, s_hi] + [rand128() for _ in range(pos_i.In_idx[1] - 3)]
        w, col = wasm_placement(pos_i, ins)
        i0 = pos_i.In_idx[0]
        link_pair(src_alu, (cell(pos_i, i0 + 1, col), cell(pos_i, i0 + 2, col)))

    # --- Accumulator consumers: first 2-limb word copies an ALU1 output ---
    for k in range(n_acc):
        src_alu, s_lo, s_hi = alu_outs[(11 * k + 3) % (len(alu_outs) - 1)]
        ins = [s_lo, s_hi] + [rand128() for _ in range(acc_i.In_idx[1] - 2)]
        w, col = wasm_placement(acc_i, ins)
        i0 = acc_i.In_idx[0]
        link_pair(src_alu, (cell(acc_i, i0, col), cell(acc_i, i0 + 1, col)))

    assert len(placements) == s_max, (len(placements), s_max)

    permutation: list[PermutationEntry] = []
    seen: set[tuple[int, int]] = set()
    cycles = [c for c in cycles if len(c) > 1]  # unconsumed outputs: no copies
    for cyc in cycles:
        for c in cyc:
            assert c not in seen, f"cell {c} in two cycles"
            seen.add(c)
        for t, (row, col) in enumerate(cyc):
            nrow, ncol = cyc[(t + 1) % len(cyc)]
            permutation.append(PermutationEntry(row=row, col=col, X=nrow, Y=ncol))

    a_pub_user = out_vals + pub_in_vals
    assert len(a_pub_user) == params.l_user
    m_block = params.l_free - params.l_user
    a_pub_block = (block_vals + [0] * m_block)[:m_block]
    assert evm_in_i.flattenMap[evm_in_i.In_idx[0]] == params.l_free
    instance = Instance(
        a_pub_user=a_pub_user,
        a_pub_block=a_pub_block,
        a_pub_function=evm_vals,
    )
    return RealFixture(
        params=params, library=library, infos=infos, placements=placements,
        permutation=permutation, instance=instance,
    )


def build_real_fixture(
    library_dir: str | None = None,
    s_max: int | None = None,
    seed: int = 11,
    include_dectobit: bool = False,
) -> RealFixture:
    """Buffer (+ optionally DecToBit) placements on the real library.

    `s_max` may be shrunk (power of two >= 4) to bound the NTT domain for
    tests; all wire-structure parameters (n, l, l_D, m_D) stay real.
    `library_dir=None` resolves through `resolve_library_path` at call time
    (the JAX package defaults to a path into a reference checkout).
    """
    library_dir = resolve_library_path(library_dir)
    params, infos, library = load_library(library_dir)
    if s_max is not None:
        assert s_max >= 4 and (s_max & (s_max - 1)) == 0
        params = dataclasses.replace(params, s_max=s_max)

    rng_state = seed
    def rand_fr():
        nonlocal rng_state
        rng_state = (rng_state * 6364136223846793005 + 1442695040888963407) % (1 << 64)
        return (rng_state * 0x9E3779B97F4A7C15) % R_MOD

    by_name = {i.name: i for i in infos}
    pub_out_i = by_name["bufferPubOut"]
    pub_in_i = by_name["bufferPubIn"]
    block_in_i = by_name["bufferBlockIn"]
    evm_in_i = by_name["bufferEVMIn"]

    pub_in_vals = [rand_fr() for _ in range(pub_in_i.In_idx[1])]
    block_vals = [rand_fr() for _ in range(block_in_i.In_idx[1])]
    evm_vals = [rand_fr() for _ in range(evm_in_i.In_idx[1])]

    # bufferPubOut echoes bufferPubIn's outputs cyclically so its inputs are
    # genuine copies of other placements' interface wires.
    n_out = pub_out_i.Out_idx[1]
    out_vals = [pub_in_vals[j % len(pub_in_vals)] for j in range(n_out)]

    placements = [
        _buffer_placement(pub_out_i, out_vals),
        _buffer_placement(pub_in_i, pub_in_vals),
        _buffer_placement(block_in_i, block_vals),
        _buffer_placement(evm_in_i, evm_vals),
    ]
    if include_dectobit:
        dec_i = by_name["DecToBit"]
        placements.append(
            _dectobit_placement(
                dec_i, rand_fr() % (1 << 128), rand_fr() % (1 << 128)
            )
        )
        placements.append(_dectobit_placement(dec_i, (1 << 128) - 1, 0))
    assert len(placements) <= params.s_max

    # Copy cycles: pubIn.out[j] (producer) <-> pubOut.in[k] for every k with
    # k % n_in == j (consumers), as (wire, placement) pairs on the interface
    # grid (row = global - l, col = placement index).
    l = params.l
    permutation: list[PermutationEntry] = []
    n_in = len(pub_in_vals)
    for j in range(n_in):
        cyc = [(pub_in_i.flattenMap[pub_in_i.Out_idx[0] + j] - l, 1)]
        for k in range(j, n_out, n_in):
            cyc.append((pub_out_i.flattenMap[pub_out_i.In_idx[0] + k] - l, 0))
        for t, (row, col) in enumerate(cyc):
            nrow, ncol = cyc[(t + 1) % len(cyc)]
            permutation.append(PermutationEntry(row=row, col=col, X=nrow, Y=ncol))

    # Instance arrays per the public wire map.
    a_pub_user = out_vals + pub_in_vals  # l_user = l_user_out + n_in
    assert len(a_pub_user) == params.l_user
    m_block = params.l_free - params.l_user
    a_pub_block = (block_vals + [0] * m_block)[:m_block]
    m_function = params.l - params.l_free
    # globals [109,128) carry no wires in the shipped library; the function
    # instance starts at l_free=128 and is exactly the EVMIn inputs.
    assert evm_in_i.flattenMap[evm_in_i.In_idx[0]] == params.l_free
    a_pub_function = evm_vals
    assert len(a_pub_function) == m_function

    instance = Instance(
        a_pub_user=a_pub_user,
        a_pub_block=a_pub_block,
        a_pub_function=a_pub_function,
    )
    return RealFixture(
        params=params, library=library, infos=infos, placements=placements,
        permutation=permutation, instance=instance,
    )
