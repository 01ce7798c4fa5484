"""PyTorch / CUDA port of the Tokamak zk-SNARK prover for one NVIDIA H100.

A second package beside the JAX one (`tokamak_zk_evm_tpu`), which stays the
reference.  The port imports torch, numpy and the standard library only.
Entry points (`models.setup.generate_sigma`, `models.prover.Prover`,
`models.preprocess.preprocess`, `models.verifier.Verifier`) run on `cuda`
unless the caller passes `device="cpu"`, where every kernel wrapper takes its
plain PyTorch version.
"""
