"""Reference artifact I/O -- the file contract between pipeline stages.

The port's copy of the JAX package's `io/artifacts.py` (JAX-free there; the
port imports nothing of that package).  The reference's layers communicate
through files: the synthesizer emits `placementVariables.json`,
`instance.json`, `permutation.json`; the qap-compiler library dir carries
`setupParams.json`, `subcircuitInfo.json` and binary circom `.r1cs` files;
the prover emits `proof.json` in the Solidity-verifier split-limb format.
This module reads and writes those exact formats into the port's protocol
dataclasses (the reference's `libs/src/iotools/mod.rs`: JSON serde :45,
HexString :128-158, SetupParams :167, PlacementVariables :367, Instance
:400, Permutation :409, SubcircuitInfo :459, binary R1CS parser :492-700,
split_g1 Solidity formatting :1625-1700), plus `canonical_proof_bytes`, the
input of the pinned proof digests.
"""

from __future__ import annotations

import json
import struct

from ..fields import R_MOD
from ..models.protocol import (
    Instance,
    PermutationEntry,
    Placement,
    Proof,
    Proof0,
    Proof1,
    Proof2,
    Proof3,
    Proof4,
    Binding,
    SetupParams,
    SubcircuitInfo,
    SubcircuitR1CS,
)


def parse_hex(s: str) -> int:
    """HexString semantics (`iotools/mod.rs:128-158`): odd-nibble inputs are
    zero-padded on the left; value is big-endian hex."""
    if s.startswith(("0x", "0X")):
        s = s[2:]
    if s == "":
        return 0
    return int(s, 16)


# ---------------------------------------------------------------------------
# JSON artifact loaders


def load_setup_params(path: str) -> SetupParams:
    """`setupParams.json` (`iotools/mod.rs:167-178`)."""
    with open(path) as f:
        d = json.load(f)
    return SetupParams(
        l_free=d["l_free"], l=d["l"], l_user_out=d["l_user_out"],
        l_user=d["l_user"], l_D=d["l_D"], m_D=d["m_D"], n=d["n"],
        s_D=d["s_D"], s_max=d["s_max"],
    )


def load_subcircuit_infos(path: str) -> list[SubcircuitInfo]:
    """`subcircuitInfo.json` (`iotools/mod.rs:459-469`)."""
    with open(path) as f:
        arr = json.load(f)
    return [
        SubcircuitInfo(
            id=d["id"], name=d["name"], Nwires=d["Nwires"],
            Out_idx=tuple(d["Out_idx"]), In_idx=tuple(d["In_idx"]),
            flattenMap=list(d["flattenMap"]),
        )
        for d in arr
    ]


def load_placement_variables(path: str) -> list[Placement]:
    """`placementVariables.json` (`iotools/mod.rs:367-372`): array of
    {subcircuitId, variables: [hex]}."""
    with open(path) as f:
        arr = json.load(f)
    return [
        Placement(
            subcircuit_id=d["subcircuitId"],
            variables=[parse_hex(v) % R_MOD for v in d["variables"]],
        )
        for d in arr
    ]


def load_instance(path: str) -> Instance:
    """`instance.json` (`iotools/mod.rs:400-407`)."""
    with open(path) as f:
        d = json.load(f)
    return Instance(
        a_pub_user=[parse_hex(v) % R_MOD for v in d["a_pub_user"]],
        a_pub_block=[parse_hex(v) % R_MOD for v in d["a_pub_block"]],
        a_pub_function=[parse_hex(v) % R_MOD for v in d["a_pub_function"]],
    )


def load_permutation(path: str) -> list[PermutationEntry]:
    """`permutation.json` (`iotools/mod.rs:409-416`)."""
    with open(path) as f:
        arr = json.load(f)
    return [
        PermutationEntry(row=d["row"], col=d["col"], X=d["X"], Y=d["Y"])
        for d in arr
    ]


# ---------------------------------------------------------------------------
# Binary circom R1CS parser


def parse_r1cs(path: str, prime: int = R_MOD) -> tuple[SubcircuitR1CS, dict]:
    """Parse a circom binary `.r1cs` file into sparse column form.

    Format (observed in `iotools/mod.rs:515-650` and the public circom
    spec): magic "r1cs", u32 version (=1), u32 section count; sections of
    (u32 type, u64 size).  Section 1 header: u32 field_size, prime bytes LE,
    u32 nWires, u32 nPubOut, u32 nPubIn, u32 nPrvIn, u64 nLabels,
    u32 mConstraints.  Section 2 constraints: per row, three linear
    combinations (A, B, C), each u32 nnz then nnz x (u32 wire, field_size
    bytes LE coeff).

    Returns (SubcircuitR1CS with wire -> [(row, coeff)] columns, header meta).
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"r1cs":
        raise ValueError(f"{path}: bad R1CS magic {data[:4]!r}")
    version, nsec = struct.unpack_from("<II", data, 4)
    if version != 1:
        raise ValueError(f"{path}: unsupported R1CS version {version}")
    off = 12
    sections: dict[int, tuple[int, int]] = {}
    for _ in range(nsec):
        styp, ssize = struct.unpack_from("<IQ", data, off)
        off += 12
        sections[styp] = (off, ssize)
        off += ssize
    if 1 not in sections or 2 not in sections:
        raise ValueError(f"{path}: missing header/constraints section")

    hoff, _hsize = sections[1]
    (fs,) = struct.unpack_from("<I", data, hoff)
    hoff += 4
    file_prime = int.from_bytes(data[hoff:hoff + fs], "little")
    if file_prime != prime:
        raise ValueError(f"{path}: R1CS prime does not match expected field")
    hoff += fs
    n_wires, n_pub_out, n_pub_in, n_prv_in = struct.unpack_from("<IIII", data, hoff)
    hoff += 16
    (n_labels,) = struct.unpack_from("<Q", data, hoff)
    hoff += 8
    (n_constraints,) = struct.unpack_from("<I", data, hoff)

    coff, csize = sections[2]
    end = coff + csize
    cols: tuple[dict, dict, dict] = ({}, {}, {})
    off = coff
    for row in range(n_constraints):
        for mat in range(3):
            (nnz,) = struct.unpack_from("<I", data, off)
            off += 4
            col = cols[mat]
            for _ in range(nnz):
                (wire,) = struct.unpack_from("<I", data, off)
                off += 4
                coeff = int.from_bytes(data[off:off + fs], "little") % prime
                off += fs
                if wire >= n_wires:
                    raise ValueError(f"{path}: wire {wire} >= nWires {n_wires}")
                col.setdefault(wire, []).append((row, coeff))
    if off != end:
        raise ValueError(f"{path}: {end - off} trailing constraint bytes")

    meta = {
        "field_size": fs, "n_wires": n_wires, "n_pub_out": n_pub_out,
        "n_pub_in": n_pub_in, "n_prv_in": n_prv_in, "n_labels": n_labels,
        "n_constraints": n_constraints,
    }
    return SubcircuitR1CS(A_cols=cols[0], B_cols=cols[1], C_cols=cols[2]), meta


def load_library(library_dir: str) -> tuple[SetupParams, list[SubcircuitInfo], list[SubcircuitR1CS]]:
    """Load a full qap-compiler library dir: `setupParams.json`,
    `subcircuitInfo.json`, and `r1cs/subcircuit{i}.r1cs` for each subcircuit
    (layout of `packages/frontend/qap-compiler/subcircuits/library/`)."""
    import os

    params = load_setup_params(os.path.join(library_dir, "setupParams.json"))
    infos = load_subcircuit_infos(os.path.join(library_dir, "subcircuitInfo.json"))
    library = []
    for info in infos:
        r1cs, meta = parse_r1cs(os.path.join(library_dir, "r1cs", f"subcircuit{info.id}.r1cs"))
        if meta["n_wires"] != info.Nwires:
            raise ValueError(
                f"subcircuit{info.id}: r1cs nWires {meta['n_wires']} != info {info.Nwires}"
            )
        library.append(r1cs)
    return params, infos, library


def write_r1cs(
    r1cs: SubcircuitR1CS,
    path: str,
    n_wires: int,
    n_pub_out: int = 0,
    n_pub_in: int = 0,
    prime: int = R_MOD,
):
    """Write a circom-format binary `.r1cs` (inverse of `parse_r1cs`) —
    used to materialize synthetic libraries in the reference's on-disk
    layout for CLI / round-trip tests."""
    rows: dict[int, tuple[dict, dict, dict]] = {}
    for mat, cols in enumerate((r1cs.A_cols, r1cs.B_cols, r1cs.C_cols)):
        for wire, col in cols.items():
            for k, coeff in col:
                rows.setdefault(k, ({}, {}, {}))[mat][wire] = coeff % prime
    n_constraints = (max(rows) + 1) if rows else 0
    fs = 32

    header = bytearray()
    header += struct.pack("<I", fs)
    header += prime.to_bytes(fs, "little")
    header += struct.pack("<IIII", n_wires, n_pub_out, n_pub_in, 0)
    header += struct.pack("<Q", n_wires)  # nLabels
    header += struct.pack("<I", n_constraints)

    cons = bytearray()
    for k in range(n_constraints):
        lcs = rows.get(k, ({}, {}, {}))
        for mat in range(3):
            lc = lcs[mat]
            cons += struct.pack("<I", len(lc))
            for wire in sorted(lc):
                cons += struct.pack("<I", wire)
                cons += lc[wire].to_bytes(fs, "little")

    with open(path, "wb") as f:
        f.write(b"r1cs")
        f.write(struct.pack("<II", 1, 2))
        f.write(struct.pack("<IQ", 1, len(header)))
        f.write(header)
        f.write(struct.pack("<IQ", 2, len(cons)))
        f.write(cons)


def save_library(
    library_dir: str,
    params: SetupParams,
    infos: list[SubcircuitInfo],
    library: list[SubcircuitR1CS],
):
    """Materialize a library in the qap-compiler on-disk layout."""
    import os

    os.makedirs(os.path.join(library_dir, "r1cs"), exist_ok=True)
    with open(os.path.join(library_dir, "setupParams.json"), "w") as f:
        json.dump(
            {k: getattr(params, k) for k in (
                "l_free", "l", "l_user_out", "l_user", "l_D", "m_D", "n",
                "s_D", "s_max")},
            f,
        )
    with open(os.path.join(library_dir, "subcircuitInfo.json"), "w") as f:
        json.dump(
            [
                {
                    "id": i.id, "name": i.name, "Nwires": i.Nwires,
                    "Nconsts": 0, "Out_idx": list(i.Out_idx),
                    "In_idx": list(i.In_idx), "flattenMap": list(i.flattenMap),
                }
                for i in infos
            ],
            f,
        )
    for info, r in zip(infos, library):
        write_r1cs(
            r, os.path.join(library_dir, "r1cs", f"subcircuit{info.id}.r1cs"),
            n_wires=info.Nwires,
        )


# ---------------------------------------------------------------------------
# Solidity-format proof.json (split-limb G1 encoding)

_G1_ORDER = (
    ("proof0", "U"), ("proof0", "V"), ("proof0", "W"),
    ("binding", "O_mid"), ("binding", "O_prv"),
    ("proof0", "Q_AX"), ("proof0", "Q_AY"),
    ("proof2", "Q_CX"), ("proof2", "Q_CY"),
    ("proof4", "Pi_X"), ("proof4", "Pi_Y"),
    ("proof0", "B"), ("proof1", "R"),
    ("proof4", "M_Y"), ("proof4", "M_X"),
    ("proof4", "N_Y"), ("proof4", "N_X"),
    ("binding", "O_pub_free"), ("binding", "A_free"),
)

_SCALAR_ORDER = ("R_eval", "R_omegaX_eval", "R_omegaX_omegaY_eval", "V_eval")


def _split_fq(v: int) -> tuple[str, str]:
    """48-byte big-endian Fq split into 16-byte + 32-byte hex limbs
    (`iotools/mod.rs:1625-1650` split_g1)."""
    b = int(v).to_bytes(48, "big")
    return "0x" + b[:16].hex(), "0x" + b[16:].hex()


def _join_fq(p1: str, p2: str) -> int:
    b = bytes.fromhex(p1[2:]) + bytes.fromhex(p2[2:])
    if len(b) != 48:
        raise ValueError(f"malformed G1 limb pair: {len(b)} bytes, want 48")
    return int.from_bytes(b, "big")


def proof_to_solidity(proof: Proof) -> dict:
    """FormattedProof (`prove/src/lib.rs:453-524`): 19 G1 points as
    (part1, part2) limb pairs per coordinate, then 4 scalar evaluations
    appended to part2 only."""
    part1: list[str] = []
    part2: list[str] = []
    for sect, name in _G1_ORDER:
        p = getattr(getattr(proof, sect), name)
        x, y = (0, 0) if p is None else (p[0], p[1])
        for coord in (x, y):
            a, b = _split_fq(coord)
            part1.append(a)
            part2.append(b)
    for name in _SCALAR_ORDER:
        v = getattr(proof.proof3, name)
        part2.append("0x" + int(v).to_bytes(32, "big").hex())
    return {"proof_entries_part1": part1, "proof_entries_part2": part2}


def proof_from_solidity(d: dict) -> Proof:
    """Inverse of `proof_to_solidity` (`prove/src/lib.rs:526-584`)."""
    p1 = d["proof_entries_part1"]
    p2 = d["proof_entries_part2"]
    n_g1 = len(_G1_ORDER)
    if len(p1) != 2 * n_g1:
        raise ValueError(f"proof part1: expected {2 * n_g1} limbs, got {len(p1)}")
    if len(p2) != 2 * n_g1 + len(_SCALAR_ORDER):
        raise ValueError(
            f"proof part2: expected {2 * n_g1 + len(_SCALAR_ORDER)} entries, "
            f"got {len(p2)}"
        )
    pts = {}
    for i, (sect, name) in enumerate(_G1_ORDER):
        x = _join_fq(p1[2 * i], p2[2 * i])
        y = _join_fq(p1[2 * i + 1], p2[2 * i + 1])
        pts[(sect, name)] = None if (x == 0 and y == 0) else (x, y)
    scalars = [parse_hex(s) % R_MOD for s in p2[2 * n_g1:]]

    def g(sect, name):
        return pts[(sect, name)]

    return Proof(
        binding=Binding(
            A_free=g("binding", "A_free"), O_pub_free=g("binding", "O_pub_free"),
            O_mid=g("binding", "O_mid"), O_prv=g("binding", "O_prv"),
        ),
        proof0=Proof0(
            U=g("proof0", "U"), V=g("proof0", "V"), W=g("proof0", "W"),
            Q_AX=g("proof0", "Q_AX"), Q_AY=g("proof0", "Q_AY"), B=g("proof0", "B"),
        ),
        proof1=Proof1(R=g("proof1", "R")),
        proof2=Proof2(Q_CX=g("proof2", "Q_CX"), Q_CY=g("proof2", "Q_CY")),
        proof3=Proof3(
            R_eval=scalars[0], R_omegaX_eval=scalars[1],
            R_omegaX_omegaY_eval=scalars[2], V_eval=scalars[3],
        ),
        proof4=Proof4(
            Pi_X=g("proof4", "Pi_X"), Pi_Y=g("proof4", "Pi_Y"),
            M_X=g("proof4", "M_X"), M_Y=g("proof4", "M_Y"),
            N_X=g("proof4", "N_X"), N_Y=g("proof4", "N_Y"),
        ),
    )


def save_proof_solidity(proof: Proof, path: str):
    with open(path, "w") as f:
        json.dump(proof_to_solidity(proof), f, indent=2)


def load_proof_solidity(path: str) -> Proof:
    with open(path) as f:
        return proof_from_solidity(json.load(f))


# ---------------------------------------------------------------------------
# Solidity-format preprocess.json (`preprocess/src/lib.rs:84-146`)


def preprocess_to_solidity(pre) -> dict:
    """FormattedPreprocess: s0, s1, O_pub_fix as split-limb pairs."""
    part1: list[str] = []
    part2: list[str] = []
    for p in (pre.s0, pre.s1, pre.O_pub_fix):
        x, y = (0, 0) if p is None else (p[0], p[1])
        for coord in (x, y):
            a, b = _split_fq(coord)
            part1.append(a)
            part2.append(b)
    return {"preprocess_entries_part1": part1, "preprocess_entries_part2": part2}


def preprocess_from_solidity(d: dict):
    from ..models.protocol import PreprocessResult

    p1 = d["preprocess_entries_part1"]
    p2 = d["preprocess_entries_part2"]
    if len(p1) != 6 or len(p2) != 6:
        raise ValueError(
            f"preprocess entries: expected 6+6, got {len(p1)}+{len(p2)}"
        )
    pts = []
    for i in range(3):
        x = _join_fq(p1[2 * i], p2[2 * i])
        y = _join_fq(p1[2 * i + 1], p2[2 * i + 1])
        pts.append(None if (x == 0 and y == 0) else (x, y))
    return PreprocessResult(s0=pts[0], s1=pts[1], O_pub_fix=pts[2])


def save_preprocess_solidity(pre, path: str):
    with open(path, "w") as f:
        json.dump(preprocess_to_solidity(pre), f, indent=2)


def load_preprocess_solidity(path: str):
    with open(path) as f:
        return preprocess_from_solidity(json.load(f))


# ---------------------------------------------------------------------------
# Writers for the synthesizer-side artifacts (test/tooling convenience; the
# reference's writer lives in the TS node-cli, `io/jsonWriter.ts`)


def save_placement_variables(placements: list[Placement], path: str):
    with open(path, "w") as f:
        json.dump(
            [
                {"subcircuitId": p.subcircuit_id,
                 "variables": [hex(v) for v in p.variables]}
                for p in placements
            ],
            f,
        )


def save_instance(instance: Instance, path: str):
    with open(path, "w") as f:
        json.dump(
            {
                "a_pub_user": [hex(v) for v in instance.a_pub_user],
                "a_pub_block": [hex(v) for v in instance.a_pub_block],
                "a_pub_function": [hex(v) for v in instance.a_pub_function],
            },
            f,
        )


def save_permutation(entries: list[PermutationEntry], path: str):
    with open(path, "w") as f:
        json.dump(
            [{"row": e.row, "col": e.col, "X": e.X, "Y": e.Y} for e in entries],
            f,
        )


# ---------------------------------------------------------------------------
# proof4_test.json — testing-mode decomposed proof components
# (`prove/src/main.rs:83-90`; struct at `prove/src/lib.rs:661-672`, serialized
# via the G1serde {x, y} hex JSON convention)
# ---------------------------------------------------------------------------

_P4T_FIELDS = (
    "Pi_AX", "Pi_AY", "Pi_CX", "Pi_CY", "Pi_B", "M_X", "M_Y", "N_X", "N_Y",
)


def _g1_coords_json(p) -> dict:
    x = p[0] if p is not None else 0
    y = p[1] if p is not None else 0
    return {"x": f"0x{x:096x}", "y": f"0x{y:096x}"}


def _g1_coords_from_json(d) -> tuple | None:
    x = parse_hex(d["x"])
    y = parse_hex(d["y"])
    return None if (x == 0 and y == 0) else (x, y)


def save_proof4test(p4t, path: str):
    from ..models.protocol import Proof4Test  # noqa: F401 (doc anchor)

    with open(path, "w") as f:
        json.dump(
            {name: _g1_coords_json(getattr(p4t, name)) for name in _P4T_FIELDS},
            f, indent=1,
        )


def load_proof4test(path: str):
    from ..models.protocol import Proof4Test

    with open(path) as f:
        d = json.load(f)
    missing = [n for n in _P4T_FIELDS if n not in d]
    if missing:
        raise ValueError(f"proof4_test.json missing fields: {missing}")
    return Proof4Test(**{n: _g1_coords_from_json(d[n]) for n in _P4T_FIELDS})


# ---------------------------------------------------------------------------
# sigma_verify.json — the verifier's slim CRS view
# (`group_structures/mod.rs:854-860` SigmaVerify {G, H, sigma_1{x,y},
# sigma_2, lagrange_KL}; written by `iotools/mod.rs:295-297`)
# ---------------------------------------------------------------------------


def _fq_hex(x: int) -> str:
    return f"0x{x:096x}"


def _g1_xy(p) -> dict:
    x, y = (0, 0) if p is None else p
    return {"x": _fq_hex(x), "y": _fq_hex(y)}


def _g1_from_xy(d):
    x, y = parse_hex(d["x"]), parse_hex(d["y"])
    return None if (x == 0 and y == 0) else (x, y)


def _g2_xy(p) -> dict:
    """Fq2 coordinate encoded as 0x || c1 || c0 (96 bytes big-endian)."""
    if p is None:
        return {"x": "0x" + "0" * 192, "y": "0x" + "0" * 192}
    (x0, x1), (y0, y1) = p
    return {
        "x": f"0x{x1:096x}{x0:096x}",
        "y": f"0x{y1:096x}{y0:096x}",
    }


def _g2_from_xy(d):
    xs, ys = d["x"][2:].rjust(192, "0"), d["y"][2:].rjust(192, "0")
    x1, x0 = int(xs[:96], 16), int(xs[96:], 16)
    y1, y0 = int(ys[:96], 16), int(ys[96:], 16)
    if x0 == x1 == y0 == y1 == 0:
        return None
    return ((x0, x1), (y0, y1))


_S2_FIELDS = ("alpha", "alpha2", "alpha3", "alpha4", "gamma", "delta", "eta",
              "x", "y")


def save_sigma_verify(sigma, path: str):
    d = {
        "G": _g1_xy(sigma.G),
        "H": _g2_xy(sigma.H),
        "sigma_1": {"x": _g1_xy(sigma.sigma_1.x), "y": _g1_xy(sigma.sigma_1.y)},
        "sigma_2": {k: _g2_xy(getattr(sigma.sigma_2, k)) for k in _S2_FIELDS},
        "lagrange_KL": _g1_xy(sigma.lagrange_KL),
    }
    with open(path, "w") as f:
        json.dump(d, f, indent=1)


def load_sigma_verify(path: str):
    """sigma_verify.json -> a Sigma carrying only the verifier's fields
    (sigma_1 families are None — enough for Verifier.verify_snark)."""
    from ..models.setup import Sigma, Sigma1, Sigma2

    with open(path) as f:
        d = json.load(f)
    s1 = Sigma1(
        xy_powers=None, h_max=0, rs_y=0, gamma_inv_o_inst=None,
        eta_inv_li_o_inter_alpha4_kj=None, delta_inv_li_o_prv=None,
        x=_g1_from_xy(d["sigma_1"]["x"]), y=_g1_from_xy(d["sigma_1"]["y"]),
        delta=None, eta=None, delta_inv_alphak_xh_tx=None,
        delta_inv_alpha4_xj_tx=None, delta_inv_alphak_yi_ty=None,
    )
    s2 = Sigma2(**{k: _g2_from_xy(d["sigma_2"][k]) for k in _S2_FIELDS})
    return Sigma(
        G=_g1_from_xy(d["G"]), H=_g2_from_xy(d["H"]), sigma_1=s1,
        sigma_2=s2, lagrange_KL=_g1_from_xy(d["lagrange_KL"]),
    )


# ---------------------------------------------------------------------------
# canonical proof bytes (the golden digests' input)
# ---------------------------------------------------------------------------


def canonical_proof_bytes(proof) -> bytes:
    """Sorted, compact JSON of `proof_to_solidity` (the golden digest input)."""
    d = proof_to_solidity(proof)
    return json.dumps(d, sort_keys=True, separators=(",", ":")).encode()
