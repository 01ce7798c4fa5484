"""The benchmark of the PyTorch/CUDA prover: see README.md."""
