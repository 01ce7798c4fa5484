"""BLS12-381 field constants and host-side (Python-int) field helpers.

The reference backend (tokamak-network/Tokamak-zk-EVM `packages/backend`) runs
entirely on BLS12-381 via ICICLE (`packages/backend/Cargo.toml:23-28`).  This
module is the port's copy of the JAX package's constants (the port imports
nothing of that package): the device kernels in `backend/csrc/` use the limb
decompositions defined here, and the host oracle (`host/`) uses the Python-int
forms directly.

Conventions (matching ICICLE / the reference):
  * Scalars serialize little-endian (`ScalarField::from_bytes_le`).
  * Roots of unity: omega_n = GENERATOR ** ((r-1)/n) mod r with GENERATOR=7,
    the canonical arkworks/ICICLE two-adic generator for BLS12-381 Fr.
"""

from __future__ import annotations

import functools

# ---------------------------------------------------------------------------
# Field moduli
# ---------------------------------------------------------------------------

# Fr: the scalar field (255 bits)
R_MOD = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# Fq: the base field (381 bits)
Q_MOD = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

FR_BITS = 255
FQ_BITS = 381

# Multiplicative generator of Fr (arkworks convention) and two-adicity.
FR_GENERATOR = 7
FR_TWO_ADICITY = 32

# ---------------------------------------------------------------------------
# Limb layout used by the device kernels: 16-bit limbs stored in uint32,
# little-endian limb order.
# ---------------------------------------------------------------------------

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

FR_LIMBS = 16  # 256 bits
FQ_LIMBS = 24  # 384 bits


def int_to_limbs(x: int, n_limbs: int) -> list[int]:
    """Little-endian 16-bit limb decomposition of a Python int."""
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n_limbs)]


def limbs_to_int(limbs) -> int:
    acc = 0
    for i, limb in enumerate(limbs):
        acc |= int(limb) << (LIMB_BITS * i)
    return acc


# ---------------------------------------------------------------------------
# Montgomery parameters (R = 2**(16 * n_limbs))
# ---------------------------------------------------------------------------


class FieldSpec:
    """Host-side description of a prime field with 16-bit-limb Montgomery form."""

    def __init__(self, modulus: int, n_limbs: int, name: str):
        self.name = name
        self.modulus = modulus
        self.n_limbs = n_limbs
        self.r_bits = LIMB_BITS * n_limbs
        self.R = 1 << self.r_bits
        self.R_mod = self.R % modulus
        self.R2_mod = (self.R * self.R) % modulus
        self.R3_mod = (self.R * self.R * self.R) % modulus
        # -p^{-1} mod 2^16 (per-digit Montgomery constant)
        self.n0_inv = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.Rinv = pow(self.R, -1, modulus)

    # -- host scalar ops (canonical representation) --
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.modulus

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.modulus

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.modulus

    def inv(self, a: int) -> int:
        return pow(a, -1, self.modulus)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.modulus)

    def neg(self, a: int) -> int:
        return (-a) % self.modulus

    # -- Montgomery conversions --
    def to_mont(self, a: int) -> int:
        return (a * self.R_mod) % self.modulus

    def from_mont(self, a: int) -> int:
        return (a * self.Rinv) % self.modulus

    # -- limb helpers --
    def to_limbs(self, a: int) -> list[int]:
        return int_to_limbs(a, self.n_limbs)

    def from_limbs(self, limbs) -> int:
        return limbs_to_int(limbs)


FR = FieldSpec(R_MOD, FR_LIMBS, "Fr")
FQ = FieldSpec(Q_MOD, FQ_LIMBS, "Fq")


@functools.lru_cache(maxsize=None)
def fr_root_of_unity(n: int) -> int:
    """Primitive n-th root of unity of Fr, n a power of two <= 2^32.

    omega_n = 7^((r-1)/n) mod r — the canonical generator chain used by
    arkworks and ICICLE (`ntt::get_root_of_unity`, see reference
    `libs/src/bivariate_polynomial/mod.rs:49-52`).
    """
    if n <= 0 or (n & (n - 1)) != 0:
        raise ValueError("root of unity order must be a power of two")
    if n > (1 << FR_TWO_ADICITY):
        raise ValueError("order exceeds the 2-adicity of Fr")
    return pow(FR_GENERATOR, (R_MOD - 1) // n, R_MOD)


# ---------------------------------------------------------------------------
# BLS12-381 curve constants
# ---------------------------------------------------------------------------

# G1: y^2 = x^3 + 4 over Fq
G1_B = 4
# Standard generator of G1 (same as ICICLE / arkworks defaults).
G1_GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

# G2: y^2 = x^3 + 4(1+u) over Fq2 = Fq[u]/(u^2+1)
G2_B = (4, 4)
G2_GEN_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_GEN_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# Fixed-entropy trapdoor used by the reference's reproducible trusted setup
# (`libs/src/field_structures/mod.rs:43-64`, Tau::gen_fixed).
TAU_FIXED = {
    "x": 0x7234CD9B97845E0125E84AE3AE81354E004558D8C82A83425652BC7B9ED49F7D % R_MOD,
    "y": 0x6ED0EEA55CBEEEBDC7A41033EBD196FFECC1806FDBC13A8D41B8F1AA273A4037 % R_MOD,
    "alpha": 0x7234CD9B97845E0125E84AE3AE81354E004558D8C82A83425652BC7B9ED49F7D % R_MOD,
    "gamma": 0x088DFE3D1B76775EC267D6D0E27B753EC904C76E0BC32CA8223DC2AE1A0AC6B4 % R_MOD,
    "delta": 0x04B8CE26374C547D8722AC51F5ED1E0F9CB891C332C69C865D96AF150189A818 % R_MOD,
    "eta": 0x52EB2AEB35B72B94A19EA232E984850F2CDA5542FDC10368955D8AC6274F8579 % R_MOD,
}

# Fixed G1/G2 generators used by `trusted-setup --fixed-tau`
# (`setup/trusted-setup/src/main.rs:69-78`).
FIXED_G1_GEN = (
    0x0B001B4CC05FA01578BE7D4E821D6FF58F2A05C584FBA3CB31A37942DECE65EADEC9A878ADD2282F7C2513ABB8D4AB05,
    0x15E237775397ED22EEF43DD36CDCA277C9CF6FA7E4FFFF0A5BB4B20A82392CAACF0F63FB6CDB02BCCF2F5AF14970D6B9,
)
_FIXED_G2_X_HEX = "1116094a7c01d4fd8abcfea69c658c92c037765bee00556b8d4063c33540b316ac68a2d913d3adc3b43c7d7cc7505cfc17206c8ae661f247979b3f1daa7fb6d5f7ce9c17b5ed1d7e8b421a2508b3f09a603e6a5fab3fcde7364fd178d656ac36"
_FIXED_G2_Y_HEX = "15bf297a4b9842fb1a3a6f2dbf6b94de06997b11b2f72436c22efbb48d2f74b0de7239ea182a2ee50c23ae3d0be6fdee09459611409874fe4b04b1a7e42cb84eb4ae01728dc55dbd1343fda8d0fe94a299fc757acc1d2602a49a005b4ff90190"


def _split_fq2_hex(h: str) -> tuple[int, int]:
    # ICICLE G2BaseField::from_hex parses the 96-byte blob little-endian as one
    # integer; limbs [0..6) are c0, limbs [6..12) are c1 when split into two
    # 48-byte field elements.  The hex string is big-endian overall, so the
    # *second* 48 bytes are the low half (c0) and the first 48 bytes are c1.
    assert len(h) == 192
    c1 = int(h[:96], 16)
    c0 = int(h[96:], 16)
    return (c0, c1)


FIXED_G2_GEN = (_split_fq2_hex(_FIXED_G2_X_HEX), _split_fq2_hex(_FIXED_G2_Y_HEX))


def fr_from_hex(h: str) -> int:
    """Parse a hex string (as found in the synthesizer JSON artifacts)."""
    if h.startswith("0x") or h.startswith("0X"):
        h = h[2:]
    if h == "":
        return 0
    return int(h, 16) % R_MOD


def fr_to_hex(x: int) -> str:
    return hex(x % R_MOD)


def hashing(seed: bytes) -> int:
    """Keccak256(seed) -> Fr element: the reference's `hashing()` helper
    (`libs/src/field_structures/mod.rs:11-23`) — 32-byte digest, top two bits
    of the last (most-significant little-endian) byte masked, read LE."""
    from .host.keccak import keccak256

    digest = bytearray(keccak256(bytes(seed)))
    digest[31] &= 0b0011_1111
    return int.from_bytes(bytes(digest), "little")
