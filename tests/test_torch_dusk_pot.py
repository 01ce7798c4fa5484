"""The port's Dusk powers-of-tau import (`models/dusk_pot.py`) against the
JAX package's, on the cases of `tests/test_dusk_pot.py`: synthetic
transcripts with a known tau, written by both packages' point encoders and
read by both readers; the same points, errors and seeded phase-1
accumulator (exact)."""

import hashlib
import json

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.host import curve as JC
from tokamak_zk_evm_tpu.models import dusk_pot as JD
from tokamak_zk_evm_tpu.models import mpc_setup as JM
from tokamak_zk_evm_tpu.models.protocol import SetupParams as JParams
from tokamak_zk_evm_tpu_torch.fields import R_MOD
from tokamak_zk_evm_tpu_torch.host import curve as C
from tokamak_zk_evm_tpu_torch.models import dusk_pot as D
from tokamak_zk_evm_tpu_torch.models import mpc_setup as M
from tokamak_zk_evm_tpu_torch.models.protocol import SetupParams

torch.set_num_threads(1)

TAU = 0xDEADBEEF12345678
N = 4  # tokamak domain size for the test transcript (10n+1 G1 powers)


def _write_transcript(mod, path, compressed, tau=TAU, n=N, corrupt_index=None):
    """The JAX test's transcript, encoded by `mod` (either package)."""
    g1_len, g2_len = 10 * n + 1, 8 * n + 1
    out = bytearray(mod.DUSK_HASH_BYTES)
    acc = 1
    for i in range(g1_len):
        p = C.g1_scalar_mul_affine(C.G1.gen, acc)
        if i == corrupt_index:
            p = C.g1_scalar_mul_affine(C.G1.gen, acc + 1)
        out += mod.g1_to_bytes(p, compressed)
        acc = acc * tau % R_MOD
    acc = 1
    for _ in range(g2_len):
        out += mod.g2_to_bytes(C.g2_scalar_mul_affine(C.G2.gen, acc), compressed)
        acc = acc * tau % R_MOD
    with open(path, "wb") as f:
        f.write(out)
    return {"g1_len": g1_len, "g2_len": g2_len}


def _same_source(a, b):
    return (a.tau_g1, a.tau_g2, a.n, a.provenance) == (b.tau_g1, b.tau_g2, b.n, b.provenance)


def test_constants_match():
    for name in ("DUSK_HASH_BYTES", "DUSK_TAU_POWERS_LENGTH", "DUSK_TAU_POWERS_G1_LENGTH",
                 "CHALLENGE_BYTES", "RESPONSE_BYTES", "PINNED_SHA256"):
        assert getattr(D, name) == getattr(JD, name), name


@pytest.mark.parametrize("compressed", [False, True])
def test_point_serialization_roundtrip(compressed):
    rng = np.random.default_rng(3)
    for _ in range(5):
        k = int.from_bytes(rng.bytes(16), "little")
        p1 = C.g1_scalar_mul_affine(C.G1.gen, k)
        b1 = D.g1_to_bytes(p1, compressed)
        assert b1 == JD.g1_to_bytes(p1, compressed)
        assert D.g1_from_bytes(b1, compressed) == JD.g1_from_bytes(b1, compressed) == p1
        q = C.g2_scalar_mul_affine(C.G2.gen, k)
        b2 = D.g2_to_bytes(q, compressed)
        assert b2 == JD.g2_to_bytes(q, compressed)
        assert D.g2_from_bytes(b2, compressed) == JD.g2_from_bytes(b2, compressed) == q
    inf = D.g1_to_bytes(None, compressed)
    assert inf == JD.g1_to_bytes(None, compressed)
    assert D.g1_from_bytes(inf, compressed) is None
    assert D.g2_to_bytes(None, compressed) == JD.g2_to_bytes(None, compressed)


@pytest.mark.parametrize("compressed", [False, True])
def test_read_and_validate(tmp_path, compressed):
    path = str(tmp_path / "pot.bin")
    layout = _write_transcript(D, path, compressed)
    jpath = str(tmp_path / "jpot.bin")
    _write_transcript(JD, jpath, compressed)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    src = D.read_dusk_pot(path, N, expected_sha256=None, file_layout=layout)
    jsrc = JD.read_dusk_pot(path, N, expected_sha256=None, file_layout=layout)
    assert _same_source(src, jsrc)
    assert src.g1() == C.G1.gen and src.g2() == C.G2.gen
    assert src.x_g2() == C.g2_scalar_mul_affine(C.G2.gen, TAU)
    assert src.alpha_g2(1) == jsrc.alpha_g2(1) == C.g2_scalar_mul_affine(
        C.G2.gen, pow(TAU, 2 * N, R_MOD))
    assert src.alphax_g1(2, 3) == jsrc.alphax_g1(2, 3) == C.g1_scalar_mul_affine(
        C.G1.gen, pow(TAU, 4 * N + 3, R_MOD))
    assert src.x_g1_range(1, 7) == jsrc.x_g1_range(1, 7)
    assert src.provenance["transcript_consistency_verified"]


def test_digest_pin_enforced(tmp_path):
    path = str(tmp_path / "pot.bin")
    layout = _write_transcript(D, path, False)
    with open(path, "rb") as f:
        actual = hashlib.sha256(f.read()).hexdigest()
    for mod in (D, JD):
        with pytest.raises(mod.DuskPotError, match="SHA-256 mismatch"):
            mod.read_dusk_pot(path, N, expected_sha256="00" * 32, file_layout=layout)
    got = D.read_dusk_pot(path, N, expected_sha256=actual, file_layout=layout)
    assert _same_source(got, JD.read_dusk_pot(path, N, expected_sha256=actual,
                                              file_layout=layout))


def test_tampered_power_rejected(tmp_path):
    path = str(tmp_path / "pot.bin")
    layout = _write_transcript(D, path, False, corrupt_index=5)
    for mod in (D, JD):
        with pytest.raises(mod.DuskPotError, match="ratio check"):
            mod.read_dusk_pot(path, N, expected_sha256=None, file_layout=layout)


def test_seeds_phase1_accumulator(tmp_path):
    """`Phase1Accumulator.from_dusk` gives the JAX package's accumulator:
    the same JSON and hash chain."""
    fields = dict(l_free=4, l=4, l_user_out=2, l_user=4, l_D=20, m_D=36, n=N, s_D=2, s_max=4)
    params, jparams = SetupParams(**fields), JParams(**fields)
    n_src = max(params.n, params.l_D - params.l)
    path = str(tmp_path / "pot.bin")
    layout = _write_transcript(D, path, False, n=n_src)
    acc = M.Phase1Accumulator.from_dusk(
        params, D.read_dusk_pot(path, n_src, expected_sha256=None, file_layout=layout))
    jacc = JM.Phase1Accumulator.from_dusk(
        jparams, JD.read_dusk_pot(path, n_src, expected_sha256=None, file_layout=layout))
    assert json.dumps(acc.to_json()) == json.dumps(jacc.to_json())
    assert acc.hash() == jacc.hash()
    assert acc.x_g1[0] == JC.g1_scalar_mul_affine(JC.G1.gen, TAU)
    assert acc.alpha_x_g1[1][2] == C.g1_scalar_mul_affine(
        C.G1.gen, pow(TAU, 2 * n_src * 2 + 3, R_MOD))
