"""Device seconds a job of the MSM kernels (K4's bucket sums and window
reduce, the names `ops.msm_device_s` reads): in the ceremony, the
coordinator's random linear combinations."""

from zkbench.metrics import load

MSM = load("ops.msm_device_s")


def read(rec):
    s = MSM.seconds(rec)
    return s / rec["proofs"] if s > 0 and rec["proofs"] else None
