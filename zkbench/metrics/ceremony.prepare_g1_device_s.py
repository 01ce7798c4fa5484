"""Device seconds a job of B13's kernels (`backend/csrc/g1_ops.cu`: the
jacobian add, the doubling and the affine scaling) in the close of phase 1:
the contribution's multiplications, the checked load's r P test and
`phase2_prepare`'s per-lane multiplications, group NTT butterflies and R1CS
sums.  The name table is `ceremony.g1_device_s`'s."""

from zkbench.metrics import load

DEVICE = load("ceremony.g1_device_s")


def read(rec):
    return DEVICE.read(rec)
