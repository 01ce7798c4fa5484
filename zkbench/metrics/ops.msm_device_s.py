"""Device seconds a proof of the kernels `ops.msm` launches: K4's bucket sums
and window reduce (`backend/csrc/msm.cu`), by kernel name.  The PyTorch glue
kernels of the MSM's plan are not in the table."""

import re

KERNELS = ("bucket_sum_kernel_affine", "bucket_sum_kernel_jacobian", "window_reduce_kernel")
_PAT = re.compile(r"\b(" + "|".join(KERNELS) + r")\b")


def seconds(rec) -> float:
    return sum(s for name, s in rec["by_name"].items() if _PAT.search(name))


def read(rec):
    s = seconds(rec)
    return s / rec["proofs"] if s > 0 and rec["proofs"] else None
