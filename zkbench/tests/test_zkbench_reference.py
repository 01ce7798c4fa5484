"""The plain reference: its Keccak, transcript and layout against the
program's, and its judgement of the program's proofs on the CPU: a sound
proof passes, a tampered one and a zero-blinded one do not."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from zkbench import gen
from zkbench.reference import curve as C
from zkbench.reference import keccak, layout
from zkbench.reference.check import Reference
from zkbench.reference.transcript import challenges

TINY = dict(l=6, l_D=22, l_free=4, l_user=2, l_user_out=1, m_D=35, n=16, s_D=5, s_max=8)


def test_keccak_vectors():
    assert keccak.keccak256(b"").hex() == \
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert keccak.keccak256(b"abc").hex() == \
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"


@pytest.mark.parametrize("size", [0, 1, 100, 135, 136, 137, 271, 272, 500])
def test_keccak_matches_the_program(size):
    from tokamak_zk_evm_tpu_torch.host.keccak import keccak256

    data = bytes(gen.rng_for(size, 9).integers(0, 256, size, dtype="uint8"))
    assert keccak.keccak256(data) == keccak256(data)


def test_lagrange_and_curve():
    z = 1234567
    basis = C.lagrange_at(z, 16)
    w = C.omega(16)
    assert sum(b * pow(w, i, C.R) for i, b in enumerate(basis)) % C.R == z
    assert sum(basis) % C.R == 1
    assert C.lagrange_at(w, 16) == [0, 1] + [0] * 14
    g5 = C.mul(C.G1_GEN, 5)
    assert C.on_curve(g5) and C.in_subgroup(g5)
    assert C.lincomb([(C.G1_GEN, 2), (C.G1_GEN, 3)]) == g5
    assert C.lincomb([(g5, 1), (C.G1_GEN, C.R - 5)]) is None


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import zkbench.reference.check, zkbench.reference.layout; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'tokamak_zk_evm_tpu', 'tokamak_zk_evm_tpu_torch', 'torch')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.fixture(scope="module")
def proved():
    """Two proofs of one job by the program on the CPU: one under the job's
    random mixer, one under Mixer.zero()."""
    from tokamak_zk_evm_tpu_torch.models.prover import Prover
    from tokamak_zk_evm_tpu_torch.models.setup import generate_sigma

    from zkbench.entries import port

    lib = gen.make_library(**TINY)
    tau = gen.make_tau(gen.rng_for(21, 0))
    sigma = generate_sigma(port.params(lib), port.tau(tau), port.library(lib), port.infos(lib),
                           device="cpu")
    job = gen.make_job(lib, 6, gen.rng_for(21, 2, 0), heavy=(1, 2))
    job.mixer = gen.make_mixer(gen.rng_for(21, 2, 0))
    out = {}
    for name, mixer in (("blinded", job.mixer), ("zero", gen.zero_mixer())):
        prover = Prover(port.params(lib), sigma, port.library(lib), port.infos(lib),
                        *port.job_inputs(job), mixer=port.mixer(mixer), device="cpu")
        proof, _ = prover.prove()
        out[name] = proof
    return lib, tau, job, out


def test_transcript_and_layout_match_the_program(proved):
    from tokamak_zk_evm_tpu_torch.io.artifacts import proof_to_solidity
    from tokamak_zk_evm_tpu_torch.models.transcript import TranscriptManager

    from zkbench.entries import port

    _, _, _, out = proved
    proof = out["blinded"]
    m = TranscriptManager()
    m.add_proof0(proof.proof0)
    thetas = m.get_thetas()
    m.add_proof1(proof.proof1)
    k0 = m.get_kappa0()
    m.add_proof2(proof.proof2)
    chi, zeta = m.get_chi_zeta()
    m.add_proof3(proof.proof3)
    k1 = m.get_kappa1()
    d = port.proof_dict(proof)
    assert challenges(d) == dict(thetas=thetas, kappa0=k0, chi=chi, zeta=zeta, kappa1=k1)
    assert layout.read(proof_to_solidity(proof)) == d


def test_sound_proof_passes(proved):
    from zkbench.entries import port

    lib, tau, job, out = proved
    ref = Reference(lib, tau)
    d = port.proof_dict(out["blinded"])
    for mixer in (job.mixer, None):
        v = ref.judge(job, d, mixer, 987654321)
        assert (v["relation_fail"], v["unblinded"], v["mismatch"]) == (0, 0, 0), v


@pytest.mark.parametrize("field", ["U", "Pi_X", "O_prv", "V_eval", "R_omegaX_eval"])
def test_tampered_proof_fails(proved, field):
    from zkbench.entries import port

    lib, tau, job, out = proved
    d = port.proof_dict(out["blinded"])
    if field.endswith("_eval"):
        d[field] = (d[field] + 1) % C.R
    else:
        d[field] = C.lincomb([(d[field], 1), (C.G1_GEN, 1)])
    assert Reference(lib, tau).judge(job, d, None, 987654321)["relation_fail"] == 1


def test_zero_blinded_proof_is_not_correct(proved):
    from zkbench.entries import port

    lib, tau, job, out = proved
    ref = Reference(lib, tau)
    d = port.proof_dict(out["zero"])
    v = ref.judge(job, d, None, 987654321)
    assert v["relation_fail"] == 0 and v["unblinded"] == 1
    v = ref.judge(job, d, job.mixer, 987654321)
    assert v["unblinded"] == 1 and v["mismatch"] == 1


def test_layout_refuses_malformed():
    good = {"proof_entries_part1": ["0x" + "00" * 16] * 38,
            "proof_entries_part2": ["0x" + "00" * 32] * 42}
    assert layout.read(good)["U"] is None
    for bad in (dict(good, proof_entries_part1=good["proof_entries_part1"][:-1]),
                dict(good, proof_entries_part2=["0x00"] * 42),
                dict(good, extra=1)):
        with pytest.raises(layout.LayoutError):
            layout.read(bad)
