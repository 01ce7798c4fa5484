"""Preprocess: commitments to the permutation polynomials + fixed public MSM.

Port of the JAX package's `models/preprocess.py` (reference
`preprocess/src/lib.rs`): s0/s1 = encode_poly of the permutation
polynomials, O_pub_fix = MSM of the fixed function-instance values against
the tail of gamma_inv_o_inst.
"""

from __future__ import annotations

from ..utils.device import resolve_device
from . import witness as W
from .protocol import Instance, PermutationEntry, PreprocessResult, SetupParams
from .prover import encode_O_pub_fix, encode_poly
from .setup import Sigma


def preprocess(sigma: Sigma, permutation: list[PermutationEntry], instance: Instance,
               params: SetupParams, device=None) -> PreprocessResult:
    device = resolve_device(device)
    params.validate()
    s0XY, s1XY = W.permutation_to_polys(permutation, params.m_i, params.s_max, device)
    s0 = encode_poly(sigma, s0XY, params)
    s1 = encode_poly(sigma, s1XY, params)
    O_pub_fix = encode_O_pub_fix(sigma, instance.a_pub_function, params)
    return PreprocessResult(s0=s0, s1=s1, O_pub_fix=O_pub_fix)
