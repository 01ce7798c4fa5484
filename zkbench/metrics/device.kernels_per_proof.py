"""Kernels the profiler saw in the traced window, the program's and
PyTorch's (memory copies and sets not counted), over the proofs completed."""


def read(rec):
    return rec["kernels"] / rec["proofs"] if rec["kernels"] and rec["proofs"] else None
