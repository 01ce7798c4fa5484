"""Protocol data structures shared by setup / preprocess / prove / verify.

Mirrors the reference's file contract (layers communicate through JSON
artifacts) and core structs:
  SetupParams    — `libs/src/iotools/mod.rs:167-178`
  SubcircuitInfo — `libs/src/iotools/mod.rs:459-469`
  Permutation    — `libs/src/iotools/mod.rs:409-457`
  Proof bundles  — `prove/src/lib.rs:439-672`
G1 points at the protocol boundary are host affine tuples ((x, y) ints) or
None for the identity; device arrays are confined to the compute layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SetupParams:
    l_free: int
    l: int
    l_user_out: int
    l_user: int
    l_D: int
    m_D: int
    n: int
    s_D: int
    s_max: int

    @property
    def m_i(self) -> int:
        return self.l_D - self.l

    def validate(self):
        for name in ("n", "s_max"):
            v = getattr(self, name)
            assert v > 0 and (v & (v - 1)) == 0, f"{name} must be a power of two"
        assert self.m_i > 0 and (self.m_i & (self.m_i - 1)) == 0, "m_i must be a power of two"


@dataclass
class SubcircuitInfo:
    id: int
    name: str
    Nwires: int
    Out_idx: tuple[int, int]  # (start, count)
    In_idx: tuple[int, int]
    flattenMap: list[int]


@dataclass
class SubcircuitR1CS:
    """Compact sparse column form: per active wire, the (constraint_index,
    coefficient) pairs of that wire's column — the sparse view of the
    reference's `SubcircuitR1CS` compact column matrices
    (`libs/src/iotools/mod.rs:492-1015`; columns there are dense length-n
    eval vectors, but real circuits are sparse and full-shape witness
    assembly requires sparsity)."""

    A_cols: dict[int, list[tuple[int, int]]]  # wire -> [(k, coeff)]
    B_cols: dict[int, list[tuple[int, int]]]
    C_cols: dict[int, list[tuple[int, int]]]


@dataclass
class Placement:
    subcircuit_id: int
    variables: list[int]  # length Nwires, Fr values


@dataclass
class PermutationEntry:
    row: int  # interface wire index (global - l)
    col: int  # placement index
    X: int  # target wire index
    Y: int  # target placement index


@dataclass
class Instance:
    a_pub_user: list[int]
    a_pub_block: list[int]
    a_pub_function: list[int]


@dataclass
class Proof0:
    U: object
    V: object
    W: object
    Q_AX: object
    Q_AY: object
    B: object


@dataclass
class Proof1:
    R: object


@dataclass
class Proof2:
    Q_CX: object
    Q_CY: object


@dataclass
class Proof3:
    V_eval: int
    R_eval: int
    R_omegaX_eval: int
    R_omegaX_omegaY_eval: int


@dataclass
class Proof4:
    Pi_X: object
    Pi_Y: object
    M_X: object
    M_Y: object
    N_X: object
    N_Y: object


@dataclass
class Proof4Test:
    """Decomposed components for testing-mode verification
    (`prove/src/lib.rs:661-672`)."""

    Pi_AX: object
    Pi_AY: object
    Pi_CX: object
    Pi_CY: object
    Pi_B: object
    M_X: object
    M_Y: object
    N_X: object
    N_Y: object


@dataclass
class Binding:
    A_free: object
    O_pub_free: object
    O_mid: object
    O_prv: object


@dataclass
class Proof:
    binding: Binding
    proof0: Proof0
    proof1: Proof1
    proof2: Proof2
    proof3: Proof3
    proof4: Proof4


@dataclass
class PreprocessResult:
    s0: object
    s1: object
    O_pub_fix: object


@dataclass
class Mixer:
    """ZK blinding scalars (`prove/src/lib.rs:251-263`)."""

    rU_X: int
    rU_Y: int
    rV_X: int
    rV_Y: int
    rW_X: list[int]  # 4 entries (3 random + 0 pad), lib.rs:1045-1060
    rW_Y: list[int]
    rB_X: list[int]  # 2 entries
    rB_Y: list[int]
    rR_X: int
    rR_Y: int
    rO_mid: int

    @staticmethod
    def random(rng):
        from ..fields import R_MOD

        def r():
            return int.from_bytes(rng.bytes(32), "little") % R_MOD

        return Mixer(
            rU_X=r(), rU_Y=r(), rV_X=r(), rV_Y=r(),
            rW_X=[r(), r(), r(), 0], rW_Y=[r(), r(), r(), 0],
            rB_X=[r(), r()], rB_Y=[r(), r()],
            rR_X=r(), rR_Y=r(), rO_mid=r(),
        )

    @staticmethod
    def zero():
        """No blinding — makes proofs deterministic for bit-exact testing."""
        return Mixer(0, 0, 0, 0, [0, 0, 0, 0], [0, 0, 0, 0], [0, 0], [0, 0], 0, 0, 0)
