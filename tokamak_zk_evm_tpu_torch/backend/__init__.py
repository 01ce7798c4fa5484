"""Compute backend of the port: hand-written CUDA kernels (csrc/), their
ctypes build (build.py), and the wrappers with their plain PyTorch versions
and launch counters (kernels.py)."""
