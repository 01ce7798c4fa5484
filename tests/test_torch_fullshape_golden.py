"""The full-shape proof digest the port is held to on the card.

`testing/synthetic.py` pins `FULLSHAPE_PROOF_SHA256`: the SHA-256 of the
canonical bytes of the JAX package's proof of `build_synthetic()` at its
defaults (n=4096, s_max=256, m_i=4096), under `Tau.fixed()` and
`Mixer.zero()`.  This test recomputes it with the JAX package (native CPU
backend, ~7 minutes on an 8-core host, hence `slow`); `chip_smoke.py`
phase 5d holds the port's proof on the card to the same digest.
"""

import hashlib
import json

import pytest

from tokamak_zk_evm_tpu.io.artifacts import proof_to_solidity
from tokamak_zk_evm_tpu.models.protocol import Mixer
from tokamak_zk_evm_tpu.models.prover import Prover
from tokamak_zk_evm_tpu.models.setup import Tau, generate_sigma
from tokamak_zk_evm_tpu.testing.synthetic import build_synthetic
from tokamak_zk_evm_tpu_torch.testing.synthetic import FULLSHAPE_PROOF_SHA256


@pytest.mark.slow
def test_jax_fullshape_proof_digest_is_pinned():
    fx = build_synthetic()
    sigma = generate_sigma(fx.params, Tau.fixed(), fx.library, fx.infos)
    proof, _ = Prover(fx.params, sigma, fx.library, fx.infos, fx.placements, fx.permutation,
                      fx.instance, mixer=Mixer.zero()).prove()
    canon = json.dumps(proof_to_solidity(proof), sort_keys=True, separators=(",", ":")).encode()
    assert hashlib.sha256(canon).hexdigest() == FULLSHAPE_PROOF_SHA256
