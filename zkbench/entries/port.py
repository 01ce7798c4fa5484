"""The generator's plain data in the program's types, and back.

The one place besides the entry adapters that imports the program, and only
its public entries: `models.protocol`, `models.setup`.
"""

from __future__ import annotations

from tokamak_zk_evm_tpu_torch.models import protocol as P
from tokamak_zk_evm_tpu_torch.models.setup import Tau


def params(lib) -> P.SetupParams:
    return P.SetupParams(**lib.params)


def infos(lib) -> list:
    return [P.SubcircuitInfo(id=d["id"], name=d["name"], Nwires=d["Nwires"],
                             Out_idx=tuple(d["Out_idx"]), In_idx=tuple(d["In_idx"]),
                             flattenMap=list(d["flattenMap"]))
            for d in lib.infos]


def library(lib) -> list:
    return [P.SubcircuitR1CS(A_cols=a, B_cols=b, C_cols=c) for a, b, c in lib.r1cs]


def tau(t: dict) -> Tau:
    return Tau(**t)


def mixer(m: dict) -> P.Mixer:
    return P.Mixer(**{k: (list(v) if isinstance(v, list) else v) for k, v in m.items()})


def job_inputs(job):
    """(placements, permutation, instance) of one job."""
    placements = [P.Placement(sid, list(v)) for sid, v in job.placements]
    permutation = [P.PermutationEntry(row=r, col=c, X=x, Y=y) for r, c, x, y in job.permutation]
    instance = P.Instance(a_pub_user=list(job.a_pub_user), a_pub_block=list(job.a_pub_block),
                          a_pub_function=list(job.a_pub_function))
    return placements, permutation, instance


def proof_dict(proof: P.Proof) -> dict:
    """The proof's points and evaluations by name, as plain ints."""
    out = {}
    for part in (proof.binding, proof.proof0, proof.proof1, proof.proof2, proof.proof4):
        for k, v in vars(part).items():
            out[k] = None if v is None else (int(v[0]), int(v[1]))
    for k, v in vars(proof.proof3).items():
        out[k] = int(v)
    return out
