"""Writers of the reference's file contract, for the CLI cell's jobs.

A library in the qap-compiler layout (`setupParams.json`,
`subcircuitInfo.json`, `r1cs/subcircuit{id}.r1cs` as circom binary R1CS,
version 1) and the synthesizer's three files (`placementVariables.json`,
`instance.json`, `permutation.json`), all from the generator's plain data.
"""

from __future__ import annotations

import json
import os
import struct

from .gen import R_MOD


def write_r1cs(cols: tuple, path: str, n_wires: int):
    """Circom's binary R1CS: a header section and a constraints section."""
    rows: dict = {}
    for mat, col in enumerate(cols):
        for wire, entries in col.items():
            for k, coeff in entries:
                rows.setdefault(k, ({}, {}, {}))[mat][wire] = coeff % R_MOD
    n_cons = max(rows) + 1 if rows else 0
    header = (struct.pack("<I", 32) + R_MOD.to_bytes(32, "little")
              + struct.pack("<IIIIQI", n_wires, 0, 0, 0, n_wires, n_cons))
    body = bytearray()
    empty = ({}, {}, {})
    for k in range(n_cons):
        for lc in rows.get(k, empty):
            body += struct.pack("<I", len(lc))
            for wire in sorted(lc):
                body += struct.pack("<I", wire) + lc[wire].to_bytes(32, "little")
    with open(path, "wb") as f:
        f.write(b"r1cs" + struct.pack("<II", 1, 2))
        f.write(struct.pack("<IQ", 1, len(header)) + header)
        f.write(struct.pack("<IQ", 2, len(body)) + body)


def write_library(lib, d: str):
    os.makedirs(os.path.join(d, "r1cs"), exist_ok=True)
    with open(os.path.join(d, "setupParams.json"), "w") as f:
        json.dump(lib.params, f)
    with open(os.path.join(d, "subcircuitInfo.json"), "w") as f:
        json.dump([dict(id=i["id"], name=i["name"], Nwires=i["Nwires"], Nconsts=0,
                        Out_idx=list(i["Out_idx"]), In_idx=list(i["In_idx"]),
                        flattenMap=list(i["flattenMap"])) for i in lib.infos], f)
    for info, cols in zip(lib.infos, lib.r1cs):
        write_r1cs(cols, os.path.join(d, "r1cs", f"subcircuit{info['id']}.r1cs"),
                   info["Nwires"])


def write_job(job, d: str):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "placementVariables.json"), "w") as f:
        json.dump([{"subcircuitId": sid, "variables": [hex(v) for v in variables]}
                   for sid, variables in job.placements], f)
    with open(os.path.join(d, "instance.json"), "w") as f:
        json.dump({"a_pub_user": [hex(v) for v in job.a_pub_user],
                   "a_pub_block": [hex(v) for v in job.a_pub_block],
                   "a_pub_function": [hex(v) for v in job.a_pub_function]}, f)
    with open(os.path.join(d, "permutation.json"), "w") as f:
        json.dump([{"row": r, "col": c, "X": x, "Y": y} for r, c, x, y in job.permutation], f)
