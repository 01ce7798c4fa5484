"""The port's CRS and artifact I/O against the JAX package's.

Mirrors `tests/test_rkyv_crs.py` (layouts, round trips per layout mode,
corrupt and truncated files, a proof on an rkyv-loaded CRS, the independent
oracle's cross-check) and the two reference-free tests of
`tests/test_io_artifacts.py`, on the port's modules, and adds the npy CRS
dir: the port's `save_sigma` writes the JAX package's bytes and each package
reads the other's files.  The toy fixture's CRS (`Tau.fixed()`) is made once
per module by each package; the port runs on the CPU.  Tolerance: exact.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.io import crs as JCRS
from tokamak_zk_evm_tpu.io import rkyv_crs as JRK
from tokamak_zk_evm_tpu.models.setup import Tau as JTau, generate_sigma as j_generate_sigma
from tokamak_zk_evm_tpu.testing.fixtures import build_fixture as j_build_fixture
from tokamak_zk_evm_tpu_torch.fields import R_MOD
from tokamak_zk_evm_tpu_torch.io import crs as TCRS
from tokamak_zk_evm_tpu_torch.io import rkyv_crs as RK
from tokamak_zk_evm_tpu_torch.io.artifacts import (
    canonical_proof_bytes, parse_hex, proof_from_solidity, proof_to_solidity,
)
from tokamak_zk_evm_tpu_torch.models.convert import sigma_from_arrays
from tokamak_zk_evm_tpu_torch.models.protocol import (
    Binding, Proof, Proof0, Proof1, Proof2, Proof3, Proof4,
)
from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
from tokamak_zk_evm_tpu_torch.testing.fixtures import GOLDEN_PROOF_SHA256, build_fixture

# The plain versions issue many small ops; one intra-op thread per test
# process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

FAMILIES = ("xy_powers", "gamma_inv_o_inst", "eta_inv_li_o_inter_alpha4_kj",
            "delta_inv_li_o_prv")
S2 = ("alpha", "alpha2", "alpha3", "alpha4", "gamma", "delta", "eta", "x", "y")


@pytest.fixture(scope="module")
def world():
    fx = build_fixture()
    jfx = j_build_fixture()
    sigma = generate_sigma(fx.params, Tau.fixed(), fx.library, fx.infos, device="cpu")
    jsigma = j_generate_sigma(jfx.params, JTau.fixed(), jfx.library, jfx.infos)
    return {"fx": fx, "params": fx.params, "sigma": sigma, "jsigma": jsigma}


def u32(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a).astype(np.uint32)


def families_equal(a, b):
    return (np.array_equal(u32(a[0]), u32(b[0])) and np.array_equal(u32(a[1]), u32(b[1]))
            and np.array_equal(u32(a[2]).astype(bool), u32(b[2]).astype(bool)))


def sigmas_equal(got, want):
    """Every family (limbs exact) and every host point of two Sigmas."""
    g1, w1 = got.sigma_1, want.sigma_1
    assert (got.G, got.H, got.lagrange_KL) == (want.G, want.H, want.lagrange_KL)
    assert (g1.h_max, g1.rs_y) == (w1.h_max, w1.rs_y)
    for f in ("x", "y", "delta", "eta", "delta_inv_alphak_xh_tx", "delta_inv_alpha4_xj_tx",
              "delta_inv_alphak_yi_ty"):
        assert getattr(g1, f) == getattr(w1, f), f
    for f in S2:
        assert getattr(got.sigma_2, f) == getattr(want.sigma_2, f), f
    for f in FAMILIES:
        assert families_equal(getattr(g1, f), getattr(w1, f)), f
    return True


def test_layout_sizes_and_offsets():
    # all candidate layouts agree on struct sizes -> root position is fixed
    for mode in RK.LAYOUT_MODES:
        assert RK.struct_layout("Sigma1Rkyv", mode).size_align == (440, 4)
        assert RK.struct_layout("SigmaRkyv", mode).size_align == (2552, 4)
        assert RK.struct_layout("Sigma2Rkyv", mode).size_align == (1728, 1)
        assert RK.struct_layout("SigmaPreprocessRkyv", mode).size_align == (16, 4)
    lin = RK.struct_layout("SigmaRkyv", "linear").offsets
    assert [lin[k][0] for k in ("G", "H", "sigma_1", "sigma_2", "lagrange_KL")] == \
        [0, 96, 288, 728, 2456]
    ad = RK.struct_layout("SigmaRkyv", "align_desc").offsets
    assert ad["sigma_1"][0] == 0 and ad["G"][0] == 440
    s1 = RK.struct_layout("Sigma1Rkyv", "align_desc").offsets
    assert s1["xy_powers"][0] == 0
    assert s1["delta_inv_alphak_yi_ty"][0] == 48
    assert s1["x"][0] == 56
    assert RK.LAYOUT_MODES == JRK.LAYOUT_MODES


@pytest.mark.parametrize("mode", RK.LAYOUT_MODES)
def test_combined_sigma_roundtrip(tmp_path, world, mode):
    """Port writer -> port reader == the Sigma written; the file is the JAX
    writer's byte for byte, and the JAX reader reads it to the same Sigma."""
    sigma, params = world["sigma"], world["params"]
    path = str(tmp_path / "combined_sigma.rkyv")
    n = RK.write_combined_sigma(sigma, params, path, mode=mode)
    assert n > 2552
    got = RK.read_combined_sigma(path, params, device="cpu")  # auto-detects the mode
    assert sigmas_equal(got, sigma)
    jpath = str(tmp_path / "jax.rkyv")
    JRK.write_combined_sigma(world["jsigma"], params, jpath, mode=mode)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    assert sigmas_equal(sigma_from_arrays(JRK.read_combined_sigma(path, params), "cpu"), sigma)


def test_sigma_preprocess_roundtrip(tmp_path, world):
    sigma, params = world["sigma"], world["params"]
    path = str(tmp_path / "sigma_preprocess.rkyv")
    RK.write_sigma_preprocess(sigma, params, path)
    xy, gi, h_max, rs_y = RK.read_sigma_preprocess(path, params, device="cpu")
    assert (h_max, rs_y) == (sigma.sigma_1.h_max, sigma.sigma_1.rs_y)
    assert families_equal(xy, sigma.sigma_1.xy_powers)
    assert families_equal(gi, sigma.sigma_1.gamma_inv_o_inst)
    jpath = str(tmp_path / "jax.rkyv")
    JRK.write_sigma_preprocess(world["jsigma"], params, jpath)
    assert open(path, "rb").read() == open(jpath, "rb").read()


def test_corrupt_file_rejected(tmp_path, world):
    sigma, params = world["sigma"], world["params"]
    path = str(tmp_path / "combined_sigma.rkyv")
    RK.write_combined_sigma(sigma, params, path)
    data = bytearray(open(path, "rb").read())
    data[len(data) - 100] ^= 0xFF  # corrupt a root point coordinate
    bad = str(tmp_path / "bad.rkyv")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(RK.RkyvError):
        RK.read_combined_sigma(bad, params, device="cpu")


def test_truncated_and_garbage_files_degrade_gracefully(tmp_path, world):
    """auto mode raises RkyvError (trying every candidate), never a raw
    ValueError/IndexError from np.frombuffer on malformed input."""
    sigma, params = world["sigma"], world["params"]
    path = str(tmp_path / "combined_sigma.rkyv")
    RK.write_combined_sigma(sigma, params, path)
    data = open(path, "rb").read()
    cases = {
        "truncated_half": data[: len(data) // 2] + data[-2552:],  # root ok, body cut
        "truncated_tiny": data[:100],
        "garbage": bytes(np.random.default_rng(0).integers(0, 256, len(data), dtype=np.uint8)),
        "zeros": bytes(len(data)),
    }
    for name, blob in cases.items():
        bad = str(tmp_path / f"{name}.rkyv")
        open(bad, "wb").write(blob)
        with pytest.raises(RK.RkyvError):
            RK.read_combined_sigma(bad, params, device="cpu")


def test_prove_on_rkyv_loaded_sigma(tmp_path, world):
    """A CRS that went through the rkyv archive proves the golden proof, and
    the proof verifies."""
    from tokamak_zk_evm_tpu_torch.models.preprocess import preprocess
    from tokamak_zk_evm_tpu_torch.models.protocol import Mixer
    from tokamak_zk_evm_tpu_torch.models.prover import Prover
    from tokamak_zk_evm_tpu_torch.models.verifier import Verifier

    sigma, params, fx = world["sigma"], world["params"], world["fx"]
    path = str(tmp_path / "combined_sigma.rkyv")
    RK.write_combined_sigma(sigma, params, path)
    got = RK.read_combined_sigma(path, params, device="cpu")
    pre = preprocess(got, fx.permutation, fx.instance, fx.params, device="cpu")
    proof, _ = Prover(fx.params, got, fx.library, fx.infos, fx.placements, fx.permutation,
                      fx.instance, mixer=Mixer.zero(), device="cpu").prove()
    assert hashlib.sha256(canonical_proof_bytes(proof)).hexdigest() == GOLDEN_PROOF_SHA256
    assert Verifier(fx.params, got, pre, fx.instance, proof, rng=np.random.default_rng(5),
                    device="cpu").verify_snark()


def test_oracle_cross_validates_primary_writer(tmp_path, world):
    """The independent decoder (`io/rkyv_oracle.py`) walks the port's archive
    to the sections the primary writer put there."""
    from tokamak_zk_evm_tpu_torch.io import rkyv_oracle as ORC

    sigma, params = world["sigma"], world["params"]
    path = str(tmp_path / "combined_sigma.rkyv")
    RK.write_combined_sigma(sigma, params, path, mode="align_desc")
    sections = ORC.parse_payload(ORC.decode_combined_sigma(open(path, "rb").read()))
    assert len(sections) == 9
    s1 = sigma.sigma_1
    assert sections[0] == b"".join(
        RK._g1_to_bytes(p) for p in (sigma.G, s1.x, s1.y, s1.delta, s1.eta, sigma.lagrange_KL))
    assert sections[1] == RK._g1_family_to_bytes(s1.xy_powers)
    assert sections[2] == RK._g1_family_to_bytes(s1.gamma_inv_o_inst)
    m_i = params.l_D - params.l
    assert sections[3] == RK._g1_family_to_bytes(s1.eta_inv_li_o_inter_alpha4_kj)
    assert len(sections[3]) == m_i * params.s_max * ORC.G1
    assert sections[4] == RK._g1_family_to_bytes(s1.delta_inv_li_o_prv)
    assert len(sections[4]) == (params.m_D - params.l_D) * params.s_max * ORC.G1
    s2 = sigma.sigma_2
    assert sections[8] == b"".join(
        RK._g2_to_bytes(p) for p in (sigma.H, s2.alpha, s2.alpha2, s2.alpha3, s2.alpha4,
                                     s2.gamma, s2.delta, s2.eta, s2.x, s2.y))


def test_oracle_rejects_garbage():
    from tokamak_zk_evm_tpu_torch.io import rkyv_oracle as ORC

    with pytest.raises(ValueError):
        ORC.decode_combined_sigma(b"not an archive")


def test_npy_crs_dir_is_the_jax_packages(tmp_path, world):
    """`save_sigma` writes the JAX package's files byte for byte (uint32
    limbs and masks); each package's `load_sigma` reads the other's dir to
    the same Sigma."""
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    TCRS.save_sigma(world["sigma"], tdir)
    JCRS.save_sigma(world["jsigma"], jdir)
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) and len(names) == 13
    for name in names:
        assert open(os.path.join(tdir, name), "rb").read() == \
            open(os.path.join(jdir, name), "rb").read(), name
    assert np.load(os.path.join(tdir, "xy_powers_x.npy")).dtype == np.uint32
    assert sigmas_equal(TCRS.load_sigma(jdir, "cpu"), world["sigma"])
    assert sigmas_equal(sigma_from_arrays(JCRS.load_sigma(tdir), "cpu"), world["sigma"])
    assert sigmas_equal(TCRS.load_sigma_any(tdir, world["params"], "cpu"), world["sigma"])


def test_legacy_npz_families_load(tmp_path, world):
    """A dir with only `sigma_families.npz` (the older format) still loads."""
    d = str(tmp_path / "legacy")
    TCRS.save_sigma(world["sigma"], d)
    arrays = {}
    for f in FAMILIES:
        for s in ("x", "y", "inf"):
            p = os.path.join(d, f"{f}_{s}.npy")
            arrays[f"{f}_{s}"] = np.load(p)
            os.remove(p)
    np.savez(os.path.join(d, "sigma_families.npz"), **arrays)
    assert sigmas_equal(TCRS.load_sigma(d, "cpu"), world["sigma"])


def test_parse_hex_odd_nibble():
    # HexString semantics: odd-length hex pads a leading zero (iotools:128-158)
    assert parse_hex("0xf") == 15
    assert parse_hex("f") == 15
    assert parse_hex("0x0") == 0
    assert parse_hex("0x10") == 16
    assert parse_hex("") == 0


def test_solidity_proof_round_trip():
    q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

    def pt(i):
        return (i * 123456789 % q, i * 987654321 % q)

    proof = Proof(
        binding=Binding(A_free=pt(1), O_pub_free=pt(2), O_mid=pt(3), O_prv=pt(4)),
        proof0=Proof0(U=pt(5), V=pt(6), W=pt(7), Q_AX=pt(8), Q_AY=pt(9), B=pt(10)),
        proof1=Proof1(R=pt(11)),
        proof2=Proof2(Q_CX=pt(12), Q_CY=pt(13)),
        proof3=Proof3(V_eval=41 % R_MOD, R_eval=42, R_omegaX_eval=43, R_omegaX_omegaY_eval=44),
        proof4=Proof4(Pi_X=pt(14), Pi_Y=pt(15), M_X=pt(16), M_Y=pt(17), N_X=pt(18), N_Y=pt(19)),
    )
    d = proof_to_solidity(proof)
    assert len(d["proof_entries_part1"]) == 38
    assert len(d["proof_entries_part2"]) == 42
    # limb widths: part1 = 16 bytes, part2 = 32 bytes
    assert all(len(s) == 2 + 32 for s in d["proof_entries_part1"])
    assert all(len(s) == 2 + 64 for s in d["proof_entries_part2"])
    assert proof_from_solidity(json.loads(json.dumps(d))) == proof
