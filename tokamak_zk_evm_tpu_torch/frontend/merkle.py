"""Sparse binary Poseidon255 Merkle tree over contract storage.

The reference's L2 state manager (tokamak-l2js, constants pinned in
`qap-compiler/subcircuits/circom/constants.circom`: nPoseidonInputs()=2,
nMtDepth()=36) maintains one depth-36 binary Merkle tree per storage
address; leaves sit at index `key mod 2^36`, empty leaves are 0, and each
parent is Poseidon255_2(left, right).  SLOAD/SSTORE replay emits
VerifyMerkleProof placements walking this tree
(`synthesizer/handlers/instructionHandler.ts:482-586`).

This is a host-side sparse implementation: only nodes on occupied paths are
materialized; everything else falls back to the per-level default hash
chain (defaults[0]=0, defaults[k+1]=Poseidon(defaults[k], defaults[k]))."""

from __future__ import annotations

MT_DEPTH = 36  # constants.circom nMtDepth()
TREE_SIZE = 1 << MT_DEPTH  # MAX_MT_LEAVES


class PoseidonSMT:
    """Sparse Merkle tree: `nodes[(level, idx)]`, level 0 = leaves."""

    def __init__(self, pose2, depth: int = MT_DEPTH,
                 _defaults: list[int] | None = None):
        self.pose2 = pose2
        self.depth = depth
        if _defaults is None:
            _defaults = [0]
            for _ in range(depth):
                d = _defaults[-1]
                _defaults.append(pose2(d, d))
        self.defaults = _defaults
        self.nodes: dict[tuple[int, int], int] = {}

    @classmethod
    def from_storage(cls, pose2, storage: dict[int, int],
                     depth: int = MT_DEPTH,
                     _defaults: list[int] | None = None) -> "PoseidonSMT":
        t = cls(pose2, depth, _defaults)
        for k, v in storage.items():
            t.set(k % (1 << depth), v)
        return t

    def node(self, level: int, idx: int) -> int:
        return self.nodes.get((level, idx), self.defaults[level])

    def leaf(self, index: int) -> int:
        return self.node(0, index)

    def set(self, index: int, value: int) -> None:
        self.nodes[(0, index)] = value
        idx = index
        for lev in range(self.depth):
            p = idx >> 1
            self.nodes[(lev + 1, p)] = self.pose2(
                self.node(lev, 2 * p), self.node(lev, 2 * p + 1))
            idx = p

    def root(self) -> int:
        return self.node(self.depth, 0)

    def proof(self, index: int) -> list[int]:
        """Sibling values along the path, leaf level first."""
        return [self.node(lev, (index >> lev) ^ 1)
                for lev in range(self.depth)]

    def verify(self, index: int, value: int, siblings: list[int]) -> bool:
        acc = value
        for lev, sib in enumerate(siblings):
            bit = (index >> lev) & 1
            acc = self.pose2(sib, acc) if bit else self.pose2(acc, sib)
        return acc == self.root()

    # frame journaling (EVM revert semantics)
    def snapshot(self) -> dict:
        return dict(self.nodes)

    def restore(self, snap: dict) -> None:
        self.nodes = snap


def memoized_pose2(pose2):
    """Cache Poseidon255_2 results — the default chain and repeated tree
    rebuilds hit identical (a, b) pairs constantly, and each WASM-calculator
    evaluation costs a full witness run."""
    cache: dict[tuple[int, int], int] = {}

    def f(a: int, b: int) -> int:
        k = (a, b)
        r = cache.get(k)
        if r is None:
            r = cache[k] = pose2(a, b)
        return r

    return f
