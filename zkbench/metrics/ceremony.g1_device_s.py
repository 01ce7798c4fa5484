"""Device seconds a job of B13's kernels (`backend/csrc/g1_ops.cu`: the
jacobian add, the doubling and the affine scaling), by kernel name: in the
ceremony, the contribution's rescaling.  K2's batch inverse ahead of the
affine kernel is not counted."""

import re

KERNELS = ("g1_add_kernel", "g1_dbl_kernel", "g1_affine_kernel")
_PAT = re.compile(r"\b(" + "|".join(KERNELS) + r")\b")


def seconds(rec, name=None) -> float:
    """Device seconds of B13's kernels, or of the one named."""
    return sum(s for k, s in rec["by_name"].items()
               if (m := _PAT.search(k)) and (name is None or m.group(1) == name))


def read(rec):
    s = seconds(rec)
    return s / rec["proofs"] if s > 0 and rec["proofs"] else None
