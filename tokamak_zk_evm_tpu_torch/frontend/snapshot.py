"""Snapshot-input synthesis: the reference's file contract for `synthesize`.

The reference CLI consumes four JSON files per transaction
(`core/src/app/synthesize.ts:31`, fixtures under
`packages/frontend/synthesizer/examples/*/`):

  previous_state_snapshot.json  L2 state-channel snapshot: per-address
                                storage keys + a Merkle-Patricia storage trie
                                (node-hash -> RLP node DB)
  transaction.json              signed L2 transaction (EdDSA pubkey + sig)
  block_info.json               block context for the replay
  contract_codes.json           address -> runtime bytecode

This module parses that contract natively — a minimal RLP decoder and a
secure-trie walker replace `tokamak-l2js`'s
`createTokamakL2StateManagerFromStateSnapshot` — and feeds
`Synthesizer.run_tx` (frontend/synthesizer.py).

The sender address derives as the low 160 bits of Poseidon255(x, y) over
the decompressed jubjub public key (`sender_address_from_pubkey`, matched
against the shipped L2StateChannel fixture), and the transaction's EdDSA
signature is verified in-circuit: `build_auth` feeds the synthesizer's
sender-auth chain (DecToBit + JubjubExpBatch + EdDsaVerify placements),
from which ORIGIN/CALLER derive.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from ..host.keccak import keccak256
from .synthesizer import AccountState, Synthesizer, TxEnv


# ---------------------------------------------------------------------------
# Minimal RLP
# ---------------------------------------------------------------------------


def rlp_decode(data: bytes):
    """Decode one RLP item -> bytes | list (must consume all input)."""
    item, rest = _rlp_item(data)
    if rest:
        raise ValueError("trailing RLP bytes")
    return item


def _rlp_item(data: bytes):
    if not data:
        raise ValueError("empty RLP")
    b0 = data[0]
    if b0 < 0x80:
        return data[:1], data[1:]
    if b0 < 0xB8:  # short string
        ln = b0 - 0x80
        return data[1:1 + ln], data[1 + ln:]
    if b0 < 0xC0:  # long string
        lln = b0 - 0xB7
        ln = int.from_bytes(data[1:1 + lln], "big")
        return data[1 + lln:1 + lln + ln], data[1 + lln + ln:]
    if b0 < 0xF8:  # short list
        ln = b0 - 0xC0
    else:
        lln = b0 - 0xF7
        ln = int.from_bytes(data[1:1 + lln], "big")
        data = data[lln:]
    body, rest = data[1:1 + ln], data[1 + ln:]
    items = []
    while body:
        item, body = _rlp_item(body)
        items.append(item)
    return items, rest


# ---------------------------------------------------------------------------
# Secure Merkle-Patricia storage trie reader
# ---------------------------------------------------------------------------


def _nibbles(b: bytes) -> list[int]:
    out = []
    for x in b:
        out.append(x >> 4)
        out.append(x & 0xF)
    return out


def _decode_path(encoded: bytes) -> tuple[list[int], bool]:
    """Hex-prefix: returns (nibbles, is_leaf)."""
    nib = _nibbles(encoded)
    flag = nib[0]
    is_leaf = flag >= 2
    odd = flag & 1
    return (nib[1:] if odd else nib[2:]), is_leaf


class StorageTrie:
    """Walk the snapshot's `storageTrieDb` (node-ref -> node RLP) from a
    root ref.

    This is a POSEIDON secure trie, not a keccak MPT: the lookup path is
    Poseidon255(key, 0) over BLS12-381 Fr (verified against the shipped
    L2StateChannel fixture — every leaf path is < the Fr modulus and
    matches the Poseidon chain the qap-compiler's Poseidon subcircuit
    computes, `templates/255bit/poseidon.circom`).  Values are RLP-encoded
    big-endian integers."""

    def __init__(self, db: dict[bytes, bytes], root: bytes, key_hash):
        self.db = db
        self.root = root
        self.key_hash = key_hash  # bytes32 -> bytes32 path

    def get(self, key32: bytes) -> int | None:
        path = _nibbles(self.key_hash(key32))
        node = self._load(self.root)
        while True:
            if node is None:
                return None
            if len(node) == 17:  # branch
                if not path:
                    val = node[16]
                    return int.from_bytes(val, "big") if val else None
                nxt = node[path[0]]
                path = path[1:]
                node = self._resolve(nxt)
            elif len(node) == 2:  # extension / leaf
                nib, is_leaf = _decode_path(node[0])
                if path[:len(nib)] != nib:
                    return None
                path = path[len(nib):]
                if is_leaf:
                    if path:
                        return None
                    return int.from_bytes(rlp_decode(node[1]), "big")
                node = self._resolve(node[1])
            else:
                raise ValueError("malformed trie node")

    def _load(self, h: bytes):
        raw = self.db.get(h)
        return None if raw is None else rlp_decode(raw)

    def _resolve(self, ref):
        if isinstance(ref, list):  # embedded node (< 32 bytes)
            return ref
        if not ref:
            return None
        return self._load(ref)


# ---------------------------------------------------------------------------
# Input-contract parsing
# ---------------------------------------------------------------------------


def _hx(v: str) -> int:
    return int(v, 16)


def _hb(v: str) -> bytes:
    s = v[2:] if v.startswith("0x") else v
    if len(s) % 2:
        s = "0" + s
    return bytes.fromhex(s)


@dataclass
class SnapshotInput:
    """Parsed SynthesisInput (`core/src/app/types.ts`)."""
    previous_state: dict
    transaction: dict
    block_info: dict
    contract_codes: list
    path: str = ""


def load_snapshot_input(directory: str) -> SnapshotInput:
    def rd(name):
        with open(os.path.join(directory, name)) as f:
            return json.load(f)

    return SnapshotInput(
        previous_state=rd("previous_state_snapshot.json"),
        transaction=rd("transaction.json"),
        block_info=rd("block_info.json"),
        contract_codes=rd("contract_codes.json"),
        path=directory,
    )


def poseidon2_fn(library_dir: str):
    """Poseidon255(a, b) -> int over BLS12-381 Fr, computed with the shipped
    Poseidon witness calculator (selector=1 = chain length 1,
    `Poseidon_circuit.circom`)."""
    from ..io.artifacts import load_library
    from .witness_calculator import SubcircuitCalculators

    _, infos, _ = load_library(library_dir)
    info = next(i for i in infos if i.name == "Poseidon")
    calcs = SubcircuitCalculators(library_dir)
    L128 = (1 << 128) - 1

    def pose2(a: int, b: int) -> int:
        ins = [1, a & L128, a >> 128, b & L128, b >> 128]
        ins += [0] * (info.In_idx[1] - len(ins))
        w = calcs.witness(info.id, ins)
        o0 = info.Out_idx[0]
        return w[o0] | (w[o0 + 1] << 128)

    return pose2


# jubjub: the BLS12-381-embedded twisted Edwards curve -x^2+y^2 = 1+d x^2 y^2
_JJ_P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
_JJ_D = (-10240 * pow(10241, -1, _JJ_P)) % _JJ_P


def _sqrt_mod(n: int) -> int | None:
    """Tonelli-Shanks square root mod the BLS12-381 scalar field."""
    p = _JJ_P
    if n == 0:
        return 0
    if pow(n, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 5
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(n, q, p), pow(n, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


def decompress_jubjub(pubkey: bytes) -> tuple[int, int]:
    """Zcash-style compressed Edwards point: 32 LE bytes of y, top bit =
    sign of x.  Returns affine (x, y)."""
    yle = int.from_bytes(pubkey, "little")
    sign = yle >> 255
    y = yle & ((1 << 255) - 1)
    num = (y * y - 1) % _JJ_P
    den = (_JJ_D * y * y + 1) % _JJ_P
    x = _sqrt_mod(num * pow(den, -1, _JJ_P) % _JJ_P)
    if x is None:
        raise ValueError("pubkey y is not on jubjub")
    if x & 1 != sign:
        x = _JJ_P - x
    return x, y


def sender_address_from_pubkey(pubkey: bytes, pose2) -> int:
    """tokamak-l2js `fromEdwardsToAddress`: decompress the jubjub point and
    take the low 160 bits of Poseidon255(x, y) — the same derivation the
    synthesizer's EdDSA chain performs in-circuit
    (`instructionHandler.ts:473-475`: AND(Poseidon(pubkey), ADDRESS_MASK)).
    Verified against the shipped L2StateChannel fixture: the resulting
    address's balance-slot key Poseidon255(addr, 0) is exactly the
    snapshot's first storage key, and the shipped signature verifies
    against this exact (x, y)."""
    x, y = decompress_jubjub(pubkey)
    return pose2(x, y) & ((1 << 160) - 1)


def build_world(inp: SnapshotInput, key_hash) -> dict[int, AccountState]:
    """Contract codes + per-address storage materialized from the tries."""
    world: dict[int, AccountState] = {}
    for entry in inp.contract_codes:
        addr = _hx(entry["address"])
        world[addr] = AccountState(code=_hb(entry["code"]))

    snap = inp.previous_state
    addrs = [_hx(a) for a in snap.get("storageAddresses", [])]
    keysets = snap.get("storageKeys", [])
    roots = snap.get("storageTrieRoots", [])
    dbs = snap.get("storageTrieDb", [])
    for i, addr in enumerate(addrs):
        acct = world.setdefault(addr, AccountState())
        db = {_hb(e["key"]): _hb(e["value"]) for e in dbs[i]}
        trie = StorageTrie(db, _hb(roots[i]), key_hash)
        for k in keysets[i]:
            key = _hx(k)
            val = trie.get(key.to_bytes(32, "big"))
            if val is not None:
                acct.storage[key] = val
    return world


def build_env(inp: SnapshotInput, pose2) -> TxEnv:
    tx = inp.transaction
    blk = inp.block_info
    caller = sender_address_from_pubkey(_hb(tx["senderPubKey"]), pose2)
    return TxEnv(
        caller=caller,
        address=_hx(tx["to"]),
        callvalue=_hx(tx.get("value", "0x0")),
        calldata=_hb(tx.get("data", "0x")),
        timestamp=_hx(blk["timeStamp"]),
        number=_hx(blk["blockNumber"]),
        gaslimit=_hx(blk["gasLimit"]),
        chainid=_hx(blk["chainId"]),
        coinbase=_hx(blk["coinBase"]),
        basefee=_hx(blk.get("baseFee", "0x0")),
        prev_block_hashes=[_hx(h) for h in blk.get("prevBlockHashes", [])],
    )


def build_auth(inp: SnapshotInput):
    """EdDSA sender-auth inputs from transaction.json: A/R decompressed from
    `senderPubKey`/`r`, scalar from `s`, and the 32 challenge message words
    [nonce, to, selector, inputs 0..28] (`bufferManager.ts:190-208`;
    FUNCTION_INPUT_LENGTH=29).  The shipped fixtures' signatures verify
    under sG == R + e*A with e = chained-Poseidon(R, A, msg)."""
    from .synthesizer import EdDsaAuth

    tx = inp.transaction
    data = _hb(tx.get("data", "0x"))
    nonce = tx.get("nonce", 0)
    if isinstance(nonce, str):
        nonce = _hx(nonce)
    inputs = []
    for i in range(29):
        w = data[4 + 32 * i:4 + 32 * i + 32]
        inputs.append(int.from_bytes(w + b"\x00" * (32 - len(w)), "big"))
    return EdDsaAuth(
        pubkey=decompress_jubjub(_hb(tx["senderPubKey"])),
        randomizer=decompress_jubjub(_hb(tx["r"])),
        s=_hx(tx["s"]),
        msg_words=[nonce, _hx(tx["to"]),
                   int.from_bytes(data[:4], "big")] + inputs,
    )


def synthesize_from_snapshot(directory: str, library_dir: str,
                             s_max: int = 256, max_steps: int = 2_000_000):
    """End-to-end `synthesizeFromSnapshotInput` equivalent: parse the
    4-file input contract, build the world state, replay the transaction
    with EdDSA sender auth when the transaction carries a signature."""
    inp = load_snapshot_input(directory)
    pose2 = poseidon2_fn(library_dir)
    world = build_world(
        inp, lambda k32: pose2(int.from_bytes(k32, "big"), 0)
        .to_bytes(32, "big"))
    env = build_env(inp, pose2)
    tx = inp.transaction
    auth = build_auth(inp) if ("r" in tx and "s" in tx) else None
    syn = Synthesizer(library_dir, s_max=s_max, hash_mode="poseidon")
    return syn.run_tx(env, world, max_steps=max_steps, auth=auth)
