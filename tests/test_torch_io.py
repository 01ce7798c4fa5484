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
import struct

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.io import crs as JCRS
from tokamak_zk_evm_tpu.io import rkyv_crs as JRK
from tokamak_zk_evm_tpu.models.setup import Tau as JTau, generate_sigma as j_generate_sigma
from tokamak_zk_evm_tpu.testing.fixtures import build_fixture as j_build_fixture
from tokamak_zk_evm_tpu_torch.fields import FQ, R_MOD
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
from tokamak_zk_evm_tpu_torch.ops import field as F
from tokamak_zk_evm_tpu_torch.testing.fixtures import GOLDEN_PROOF_SHA256, build_fixture
from tokamak_zk_evm_tpu_torch.utils import timing

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


def old_g1_family(data: bytes, pos: int, n: int):
    """The reader's decode before the device one, kept as the oracle: numpy
    byte shuffles to [24, n] canonical limb columns, then one Fq product by
    R^2 (`F.fq_mul`)."""
    raw = np.frombuffer(data, dtype=np.uint8, count=n * 96, offset=pos).reshape(n, 96)
    r2 = F.tensor(np.array(FQ.to_limbs(FQ.R2_mod), np.int32).reshape(FQ.n_limbs, 1), "cpu")

    def cols(half):
        limbs = half.copy().view("<u2").astype(np.int32).T  # [24, n]
        return F.fq_mul(torch.from_numpy(np.ascontiguousarray(limbs)), r2)

    inf = ~np.any(raw, axis=1)
    return cols(raw[:, :48]), cols(raw[:, 48:]), torch.from_numpy(inf.astype(np.int32))


def old_families(data: bytes, params, preprocess: bool = False, mode: str = "align_desc"):
    """{family: (px, py, pinf)} of an archive by the old decode, every
    vec-of-vecs row by row."""
    buf = memoryview(data)
    struct_name, s1_name, field = (("SigmaPreprocessRkyv", "PartialSigma1Rkyv", "sigma_1")
                                   if preprocess else ("SigmaRkyv", "Sigma1Rkyv", "sigma_1"))
    size, _ = RK.struct_layout(struct_name, mode).size_align
    base = len(data) - size + RK.struct_layout(struct_name, mode).offsets[field][0]
    lay = RK.struct_layout(s1_name, mode).offsets
    out = {}
    for name in FAMILIES[:2] if preprocess else FAMILIES:
        pos, n = RK._read_vec_header(buf, base + lay[name][0])
        if name in FAMILIES[:2]:
            out[name] = old_g1_family(data, pos, n)
            continue
        rows = [old_g1_family(data, *RK._read_vec_header(buf, pos + 8 * r)) for r in range(n)]
        out[name] = (torch.cat([r[0] for r in rows], 1), torch.cat([r[1] for r in rows], 1),
                     torch.cat([r[2] for r in rows]))
    return out


def swap_first_rows(data: bytes, params, field: str, mode: str = "align_desc") -> bytes:
    """The archive with rows 0 and 1 of a vec-of-vecs family swapped in the
    file and their headers swapped to match: the same Sigma, rows no longer
    contiguous."""
    out = bytearray(data)
    size, _ = RK.struct_layout("SigmaRkyv", mode).size_align
    base = len(data) - size + RK.struct_layout("SigmaRkyv", mode).offsets["sigma_1"][0]
    opos, _ = RK._read_vec_header(memoryview(data), base +
                                  RK.struct_layout("Sigma1Rkyv", mode).offsets[field][0])
    (p0, n0), (p1, n1) = (RK._read_vec_header(memoryview(data), opos + 8 * r) for r in (0, 1))
    row = 96 * n0
    out[p0:p0 + row], out[p1:p1 + row] = data[p1:p1 + row], data[p0:p0 + row]
    out[opos:opos + 8] = struct.pack("<iI", p1 - opos, n0)
    out[opos + 8:opos + 16] = struct.pack("<iI", p0 - opos - 8, n1)
    return bytes(out)


def zero_entries(data: bytes, params, mode: str = "align_desc") -> bytes:
    """The archive with entry 3 of xy_powers and the last entry of
    delta_inv_li_o_prv set to all zero bytes (infinity), and the x half of
    entry 5 of xy_powers zeroed (not infinity: y is not)."""
    out = bytearray(data)
    size, _ = RK.struct_layout("SigmaRkyv", mode).size_align
    base = len(data) - size + RK.struct_layout("SigmaRkyv", mode).offsets["sigma_1"][0]
    lay = RK.struct_layout("Sigma1Rkyv", mode).offsets
    xy, _ = RK._read_vec_header(memoryview(data), base + lay["xy_powers"][0])
    opos, rows = RK._read_vec_header(memoryview(data), base + lay["delta_inv_li_o_prv"][0])
    last, n = RK._read_vec_header(memoryview(data), opos + 8 * (rows - 1))
    for p in (xy + 96 * 3, last + 96 * (n - 1)):
        out[p:p + 96] = bytes(96)
    out[xy + 96 * 5:xy + 96 * 5 + 48] = bytes(48)
    return bytes(out)


@pytest.mark.parametrize("case", ["contiguous", "rows", "infinity", "chunk", "preprocess"])
def test_device_decode_equals_old_decode(tmp_path, world, case):
    """The mapped reader's families (staged chunks, `kernels.crs_decode`'s
    plain version on the CPU) equal the old numpy decode bit for bit: on
    contiguous sections, on rows laid out apart, with all-zero entries, with
    a staging chunk of 7 entries (smaller than a section, dividing none),
    and for sigma_preprocess.rkyv; the counters give the bytes staged and
    the sections read row by row."""
    sigma, params = world["sigma"], world["params"]
    path = str(tmp_path / "archive.rkyv")
    if case == "preprocess":
        RK.write_sigma_preprocess(sigma, params, path)
    else:
        RK.write_combined_sigma(sigma, params, path)
    data = open(path, "rb").read()
    if case in ("rows", "infinity"):
        data = (swap_first_rows(data, params, "delta_inv_li_o_prv") if case == "rows"
                else zero_entries(data, params))
        open(path, "wb").write(data)
    want = old_families(data, params, preprocess=case == "preprocess")
    chunk = 7 if case == "chunk" else RK.STAGE_POINTS
    parse = RK._parse_preprocess if case == "preprocess" else RK._parse_combined
    with timing.tracing():
        got = RK._load(path, parse, params, "auto", torch.device("cpu"), chunk_points=chunk)
        counts = timing.snapshot().counts
    if case == "preprocess":
        got_families = dict(zip(FAMILIES[:2], got[:2]))
        assert got[2:] == (sigma.sigma_1.h_max, sigma.sigma_1.rs_y)
    else:
        got_families = {f: getattr(got.sigma_1, f) for f in FAMILIES}
    assert set(got_families) == set(want)
    for f, fam in got_families.items():
        assert all(a.dtype == torch.int32 for a in fam), f
        assert all(torch.equal(a, b) for a, b in zip(fam, want[f])), f
        if case != "infinity":
            assert families_equal(fam, getattr(sigma.sigma_1, f)), f
    if case == "infinity":
        for fam, col in ((got.sigma_1.xy_powers, 3), (got.sigma_1.delta_inv_li_o_prv, -1)):
            assert int(fam[2][col]) == 1 and not fam[0][:, col].any() and not fam[1][:, col].any()
        assert int(got.sigma_1.xy_powers[2].sum()) == 1
    entries = sum(int(fam[2].numel()) for fam in got_families.values())
    assert counts[(None, "crs.staged_bytes", ())] == 96 * entries
    assert counts.get((None, "crs.rows_fallback", ()), 0) == (1 if case == "rows" else 0)


def test_crs_decode_source_constants():
    """csrc/crs_decode.cu's R^2 words are R^2 mod q, and its entry is the
    96-byte G1 entry the reader stages."""
    import pathlib
    import re

    from tokamak_zk_evm_tpu_torch.backend import kernels as K

    src = (pathlib.Path(K.__file__).parent / "csrc" / "crs_decode.cu").read_text()
    body = src[src.index("r2w(int k)"):src.index("store_limbs")]
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)]
    assert sum(w << (32 * k) for k, w in enumerate(words)) == FQ.R2_mod
    assert len(words) == 12 and K.G1_ENTRY_BYTES == RK.G1_BYTES == 96


def test_malformed_sections_raise(tmp_path, world):
    """Errors of the mapped reader are RkyvErrors: an empty file, a family
    length off by one, a row pointing past the end, a file cut inside a
    section."""
    sigma, params = world["sigma"], world["params"]
    path = str(tmp_path / "combined_sigma.rkyv")
    RK.write_combined_sigma(sigma, params, path)
    data = open(path, "rb").read()
    size, _ = RK.struct_layout("SigmaRkyv", "align_desc").size_align
    base = len(data) - size + RK.struct_layout("SigmaRkyv", "align_desc").offsets["sigma_1"][0]
    lay = RK.struct_layout("Sigma1Rkyv", "align_desc").offsets
    xy_field = base + lay["xy_powers"][0]
    xy_pos, xy_n = RK._read_vec_header(memoryview(data), xy_field)
    prv_pos, _ = RK._read_vec_header(memoryview(data), base + lay["delta_inv_li_o_prv"][0])

    def patched(at, value):
        out = bytearray(data)
        out[at:at + 8] = value
        return bytes(out)

    cases = {
        "empty": b"",
        "xy_len": patched(xy_field, struct.pack("<iI", xy_pos - xy_field, xy_n + 1)),
        "row_past_end": patched(prv_pos, struct.pack("<iI", len(data) - prv_pos, params.s_max)),
        "cut": data[:xy_pos + 96 * 5] + data[-size:],
    }
    for name, blob in cases.items():
        bad = str(tmp_path / f"{name}.rkyv")
        open(bad, "wb").write(blob)
        with pytest.raises(RK.RkyvError):
            RK.read_combined_sigma(bad, params, device="cpu")


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
