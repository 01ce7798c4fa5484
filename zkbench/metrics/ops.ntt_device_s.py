"""Device seconds a proof of the kernels `ops.ntt` launches: K3's pass
kernel (`backend/csrc/ntt.cu`), by kernel name.  A coset's K1 product and
the four-step split's twiddle product are field kernels, not in the table."""

import re

KERNELS = ("ntt_pass_kernel",)
_PAT = re.compile(r"\b(" + "|".join(KERNELS) + r")\b")


def seconds(rec) -> float:
    return sum(s for name, s in rec["by_name"].items() if _PAT.search(name))


def read(rec):
    s = seconds(rec)
    return s / rec["proofs"] if s > 0 and rec["proofs"] else None
