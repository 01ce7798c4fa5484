"""The port's synthesizer, snapshot and Merkle copies against the JAX package's.

* `frontend/merkle.PoseidonSMT` with a `pose2` defined here: set, root,
  proof, verify, snapshot and restore at full depth over a sparse key set,
  and a dense tree at a small depth recomputed level by level;
  `memoized_pose2` calls the hash once a pair.
* `frontend/synthesizer._evm_alu` on every op name it handles (read off
  its source), with random 256-bit words and 0, 1, 2^255 and 2^256 - 1;
  `Synthesizer._valid_jumpdests` on random bytecode with PUSH data.
* `frontend/snapshot`: `rlp_decode` on strings and lists of every length
  form; `_sqrt_mod` and `decompress_jubjub` (the point on the curve);
  `sender_address_from_pubkey`; `StorageTrie` over an extension, a branch
  with hashed and embedded leaves, and a lone leaf, built here; then
  `load_snapshot_input`, `build_world`, `build_env` and `build_auth` on the
  four JSON files of the input contract, written here.
* What no input built here reaches (a replay needs the 14-subcircuit
  library: `Synthesizer.run_tx` and its placement methods,
  `synthesize_from_snapshot`, `poseidon2_fn`, `build_real_*_fixture`):
  each copied module's AST, docstrings removed, equals the JAX module's.
  The one difference allowed is named: `testing/real_fixture.py`'s
  `library_dir` default, `REFERENCE_LIBRARY` (a path into a reference
  checkout) in the JAX package, resolved at call time through
  `io/subcircuit_library.resolve_library_path` in the port.

Inputs come from numpy seeds.  Tolerance: exact.
"""

import ast
import dataclasses
import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.frontend import merkle as JM
from tokamak_zk_evm_tpu.frontend import snapshot as JSn
from tokamak_zk_evm_tpu.frontend import synthesizer as JSy
from tokamak_zk_evm_tpu_torch.fields import R_MOD
from tokamak_zk_evm_tpu_torch.frontend import merkle as TM
from tokamak_zk_evm_tpu_torch.frontend import snapshot as TSn
from tokamak_zk_evm_tpu_torch.frontend import synthesizer as TSy

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
M256 = 1 << 256


def pose2(a, b):
    """A stand-in for Poseidon255(a, b): SHA-256 of both words, mod r."""
    d = hashlib.sha256(a.to_bytes(32, "big") + b.to_bytes(32, "big")).digest()
    return int.from_bytes(d, "big") % R_MOD


# ---------------------------------------------------------------------------
# merkle
# ---------------------------------------------------------------------------


def test_poseidon_smt_matches_jax_at_full_depth():
    rng = np.random.default_rng(36)
    keys = [int(rng.integers(0, 1 << 36)) for _ in range(12)] + [0, (1 << 36) - 1]
    storage = {k: int.from_bytes(rng.bytes(32), "big") % R_MOD for k in keys}
    t = TM.PoseidonSMT.from_storage(pose2, storage)
    j = JM.PoseidonSMT.from_storage(pose2, storage)
    assert t.depth == j.depth == TM.MT_DEPTH == 36 and TM.TREE_SIZE == JM.TREE_SIZE == 1 << 36
    assert t.defaults == j.defaults and t.root() == j.root()
    for k in keys + [12345]:
        proof = t.proof(k)
        assert proof == j.proof(k) and len(proof) == 36
        assert t.leaf(k) == j.leaf(k) == storage.get(k, 0)
        assert t.verify(k, t.leaf(k), proof) and j.verify(k, j.leaf(k), proof)
        assert not t.verify(k, t.leaf(k) + 1, proof) and not j.verify(k, j.leaf(k) + 1, proof)
    snap_t, snap_j, root0 = t.snapshot(), j.snapshot(), t.root()
    for tree in (t, j):
        tree.set(keys[0], 7)
        tree.set(777, 9)
    assert t.root() == j.root() != root0
    assert t.verify(777, 9, t.proof(777)) and j.verify(777, 9, j.proof(777))
    t.restore(snap_t)
    j.restore(snap_j)
    assert t.root() == j.root() == root0


def test_poseidon_smt_dense_small_depth():
    rng = np.random.default_rng(4)
    leaves = [int(rng.integers(0, 1000)) for _ in range(16)]
    for mod in (TM, JM):
        tree = mod.PoseidonSMT(pose2, depth=4)
        for i, v in enumerate(leaves):
            tree.set(i, v)
        level = list(leaves)
        while len(level) > 1:
            level = [pose2(level[2 * i], level[2 * i + 1]) for i in range(len(level) // 2)]
        assert tree.root() == level[0]
        empty = mod.PoseidonSMT(pose2, depth=4)
        assert empty.defaults[0] == 0 and empty.defaults[1] == pose2(0, 0)


def test_memoized_pose2_matches_jax():
    calls = []

    def counted(a, b):
        calls.append((a, b))
        return pose2(a, b)

    for mod in (TM, JM):
        calls.clear()
        f = mod.memoized_pose2(counted)
        assert [f(1, 2), f(1, 2), f(2, 1), f(1, 2)] == \
            [pose2(1, 2), pose2(1, 2), pose2(2, 1), pose2(1, 2)]
        assert calls == [(1, 2), (2, 1)]


# ---------------------------------------------------------------------------
# synthesizer: the EVM's value path
# ---------------------------------------------------------------------------


def alu_ops():
    src = (ROOT / "tokamak_zk_evm_tpu" / "frontend" / "synthesizer.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "_evm_alu")
    return sorted({c.comparators[0].value for c in ast.walk(fn)
                   if isinstance(c, ast.Compare) and isinstance(c.left, ast.Name)
                   and c.left.id == "name"})


@pytest.mark.parametrize("name", alu_ops())
def test_evm_alu_matches_jax(name):
    rng = np.random.default_rng(sum(name.encode()))
    edge = [0, 1, 1 << 255, M256 - 1]
    words = edge + [int.from_bytes(rng.bytes(32), "big") for _ in range(6)] \
        + [int(rng.integers(0, 40)) for _ in range(3)] + [255, 256]
    for a in words:
        for b in words:
            for c in (0, 1, words[5], M256 - 1):
                got = TSy._evm_alu(name, [a, b, c])
                assert got == JSy._evm_alu(name, [a, b, c]), (name, a, b, c)
                assert 0 <= got < M256
    with pytest.raises(NotImplementedError):
        TSy._evm_alu("EXP", [2, 3])


def test_evm_alu_spot_values():
    f = TSy._evm_alu
    neg = lambda v: (M256 - v) % M256  # noqa: E731
    assert {"SDIV", "SMOD", "SIGNEXTEND", "BYTE", "SAR", "ADDMOD", "MULMOD"} <= set(alu_ops())
    assert f("SDIV", [neg(7), 2]) == neg(3) and f("SMOD", [neg(7), 2]) == neg(1)
    assert f("SIGNEXTEND", [0, 0xFF]) == M256 - 1 and f("SIGNEXTEND", [0, 0x7F]) == 0x7F
    assert f("BYTE", [31, 0xABCD]) == 0xCD and f("BYTE", [32, 0xABCD]) == 0
    assert f("SAR", [1, neg(4)]) == neg(2) and f("SAR", [300, neg(4)]) == M256 - 1
    assert f("ADDMOD", [M256 - 1, 2, 7]) == (M256 + 1) % 7 and f("MULMOD", [3, 4, 0]) == 0


def jumpdests(code):
    out, pc = set(), 0
    while pc < len(code):
        if code[pc] == 0x5B:
            out.add(pc)
        pc += 1 + (code[pc] - 0x5F if 0x60 <= code[pc] <= 0x7F else 0)
    return out


def test_valid_jumpdests_matches_jax():
    rng = np.random.default_rng(91)
    for n in (0, 1, 33, 200, 1000):
        pool = np.array([0x5B] * 6 + [0x60, 0x61, 0x7F, 0x7E] + list(range(0x00, 0x20)))
        code = bytes(int(x) for x in rng.choice(pool, size=n))
        got = TSy.Synthesizer._valid_jumpdests(code)
        assert got == JSy.Synthesizer._valid_jumpdests(code) == jumpdests(code)
    # a 0x5B inside PUSH2's data is no target; the one after it is
    assert TSy.Synthesizer._valid_jumpdests(bytes([0x61, 0x5B, 0x5B, 0x5B])) == {3}


# ---------------------------------------------------------------------------
# snapshot: RLP, jubjub, the storage trie, the four-file contract
# ---------------------------------------------------------------------------


def rlp(x):
    def head(n, off):
        if n < 56:
            return bytes([off + n])
        b = n.to_bytes((n.bit_length() + 7) // 8, "big")
        return bytes([off + 55 + len(b)]) + b

    if isinstance(x, list):
        body = b"".join(rlp(i) for i in x)
        return head(len(body), 0xC0) + body
    if len(x) == 1 and x[0] < 0x80:
        return x
    return head(len(x), 0x80) + x


def test_rlp_decode_matches_jax():
    items = [b"", b"\x00", b"\x7f", b"\x80", b"dog", bytes(55), bytes(56), bytes(300),
             [], [b"cat", b"dog"], [b"a" * 60], [[], [[]], [b"x", [b"y" * 70]]]]
    for it in items:
        enc = rlp(it)
        assert TSn.rlp_decode(enc) == JSn.rlp_decode(enc) == it
    for bad in (b"", rlp(b"dog") + b"\x00"):
        for mod in (TSn, JSn):
            with pytest.raises(ValueError):
                mod.rlp_decode(bad)


def on_jubjub(x, y):
    p, d = TSn._JJ_P, TSn._JJ_D
    return (-x * x + y * y - 1 - d * x * x * y * y) % p == 0


def jubjub_keys(rng, n):
    """n compressed jubjub points (32 LE bytes of y, x's parity in the top
    bit) and the y values that are not on the curve."""
    keys, off = [], []
    while len(keys) < n or not off:
        y = int.from_bytes(rng.bytes(32), "little") % TSn._JJ_P
        num, den = (y * y - 1) % TSn._JJ_P, (TSn._JJ_D * y * y + 1) % TSn._JJ_P
        if pow(num * pow(den, -1, TSn._JJ_P) % TSn._JJ_P, (TSn._JJ_P - 1) // 2, TSn._JJ_P) != 1:
            off.append(y)
            continue
        sign = int(rng.integers(0, 2))
        keys.append((y | sign << 255).to_bytes(32, "little"))
    return keys[:n], off


def test_sqrt_mod_matches_jax():
    rng = np.random.default_rng(2)
    p = TSn._JJ_P
    assert TSn._JJ_P == JSn._JJ_P == R_MOD and TSn._JJ_D == JSn._JJ_D
    for _ in range(20):
        n = int.from_bytes(rng.bytes(32), "big") % p
        r = TSn._sqrt_mod(n)
        assert r == JSn._sqrt_mod(n)
        if pow(n, (p - 1) // 2, p) == 1:
            assert r * r % p == n
        else:
            assert r is None
    assert TSn._sqrt_mod(0) == JSn._sqrt_mod(0) == 0


def test_jubjub_and_sender_address_match_jax():
    rng = np.random.default_rng(3)
    keys, off = jubjub_keys(rng, 6)
    for key in keys:
        x, y = TSn.decompress_jubjub(key)
        assert (x, y) == JSn.decompress_jubjub(key)
        assert on_jubjub(x, y) and x & 1 == key[31] >> 7
        assert y == int.from_bytes(key, "little") & ((1 << 255) - 1)
        addr = TSn.sender_address_from_pubkey(key, pose2)
        assert addr == JSn.sender_address_from_pubkey(key, pose2) == pose2(x, y) % (1 << 160)
    for mod in (TSn, JSn):
        with pytest.raises(ValueError, match="not on jubjub"):
            mod.decompress_jubjub(off[0].to_bytes(32, "little"))


def hp(nibbles, leaf):
    """Hex-prefix encoding of a nibble path."""
    flag = (2 if leaf else 0) + (len(nibbles) & 1)
    nib = [flag] + ([] if len(nibbles) & 1 else [0]) + list(nibbles)
    return bytes(nib[i] << 4 | nib[i + 1] for i in range(0, len(nib), 2))


def be(v):
    return v.to_bytes((v.bit_length() + 7) // 8, "big")


def nibbles_of(b):
    return [n for x in b for n in (x >> 4, x & 0xF)]


def build_trie(rng):
    """Key -> path (32 bytes) and value; the node DB and the root ref of a
    trie: an extension over [a, b] into a branch whose slots 1 and 2 hold
    hashed leaves and slot 3 an embedded one, and missing keys that leave
    it at the extension, at an empty slot and at a leaf."""
    def path(head):
        return bytes.fromhex("".join(f"{n:x}" for n in head) + rng.bytes(32).hex()[len(head):])

    paths = {1: path([0xA, 0xB, 1]), 2: path([0xA, 0xB, 2]), 3: path([0xA, 0xB, 3]),
             4: path([0xC]), 5: path([0xA, 0xB, 4]), 6: path([0xA, 0xB, 1, 0])}
    if paths[6] == paths[1]:
        paths[6] = path([0xA, 0xB, 1, 1])
    values = {1: 0x1234, 2: 1 << 200, 3: 7}
    db = {}

    def ref(node):
        enc = rlp(node)
        h = hashlib.sha256(enc).digest()
        db[h] = enc
        return h

    def leaf(k):
        return [hp(nibbles_of(paths[k])[3:], True), rlp(be(values[k]))]

    branch = [b""] * 17
    branch[1], branch[2], branch[3] = ref(leaf(1)), ref(leaf(2)), leaf(3)
    root = ref([hp([0xA, 0xB], False), ref(branch)])
    return paths, values, db, root


def test_storage_trie_matches_jax():
    paths, values, db, root = build_trie(np.random.default_rng(8))
    key_hash = lambda k32: paths[int.from_bytes(k32, "big")]  # noqa: E731
    t, j = TSn.StorageTrie(db, root, key_hash), JSn.StorageTrie(db, root, key_hash)
    for k in paths:
        k32 = k.to_bytes(32, "big")
        assert t.get(k32) == j.get(k32) == values.get(k)
    lone = rlp([hp(nibbles_of(paths[1]), True), rlp(be(99))])
    h = hashlib.sha256(lone).digest()
    for mod in (TSn, JSn):
        tr = mod.StorageTrie({h: lone}, h, key_hash)
        assert [tr.get(k.to_bytes(32, "big")) for k in (1, 2)] == [99, None]
        assert mod.StorageTrie({}, h, key_hash).get((1).to_bytes(32, "big")) is None


def write_snapshot(d, rng):
    """The four JSON files of the input contract; -> what they hold."""
    paths, values, db, root = build_trie(rng)
    lone = rlp([hp(nibbles_of(paths[2]), True), rlp(be(42))])
    lone_ref = hashlib.sha256(lone).digest()
    (pub, rpt), _ = jubjub_keys(rng, 2)
    hx = lambda b: "0x" + b.hex()  # noqa: E731
    data = bytes.fromhex("a9059cbb") + rng.bytes(32) + rng.bytes(20)
    files = {
        "previous_state_snapshot.json": {
            "storageAddresses": ["0xaa", "0xbb"],
            "storageKeys": [[hex(k) for k in (1, 2, 3, 4, 5, 6)], ["0x2", "0x3"]],
            "storageTrieRoots": [hx(root), hx(lone_ref)],
            "storageTrieDb": [[{"key": hx(k), "value": hx(v)} for k, v in db.items()],
                              [{"key": hx(lone_ref), "value": hx(lone)}]],
        },
        "transaction.json": {"senderPubKey": hx(pub), "r": hx(rpt), "s": "0x1d", "to": "0xaa",
                             "value": "0x5", "data": hx(data), "nonce": "0x3"},
        "block_info.json": {"timeStamp": "0x65", "blockNumber": "0x10", "gasLimit": "0x1c9c380",
                            "chainId": "0x1", "coinBase": "0xcc", "baseFee": "0x7",
                            "prevBlockHashes": ["0x01", "0x02"]},
        "contract_codes.json": [{"address": "0xaa", "code": "0x6001600055"},
                                {"address": "0xdd", "code": "0x00"}],
    }
    for name, obj in files.items():
        (d / name).write_text(json.dumps(obj))
    return paths, values, pub, rpt, data


def test_snapshot_contract_matches_jax(tmp_path):
    paths, values, pub, rpt, data = write_snapshot(tmp_path, np.random.default_rng(12))
    key_hash = lambda k32: paths[int.from_bytes(k32, "big")]  # noqa: E731
    t_in, j_in = TSn.load_snapshot_input(str(tmp_path)), JSn.load_snapshot_input(str(tmp_path))
    assert dataclasses.asdict(t_in) == dataclasses.asdict(j_in)

    t_world, j_world = TSn.build_world(t_in, key_hash), JSn.build_world(j_in, key_hash)
    as_dict = lambda w: {a: dataclasses.asdict(s) for a, s in w.items()}  # noqa: E731
    assert as_dict(t_world) == as_dict(j_world) == {
        0xAA: {"code": bytes.fromhex("6001600055"), "storage": values, "balance": 0},
        0xBB: {"code": b"", "storage": {2: 42}, "balance": 0},
        0xDD: {"code": b"\x00", "storage": {}, "balance": 0},
    }

    t_env, j_env = TSn.build_env(t_in, pose2), JSn.build_env(j_in, pose2)
    assert dataclasses.asdict(t_env) == dataclasses.asdict(j_env)
    assert (t_env.caller, t_env.address, t_env.callvalue, t_env.calldata, t_env.number,
            t_env.basefee, t_env.prev_block_hashes) == (
        TSn.sender_address_from_pubkey(pub, pose2), 0xAA, 5, data, 16, 7, [1, 2])

    t_auth, j_auth = TSn.build_auth(t_in), JSn.build_auth(j_in)
    assert dataclasses.asdict(t_auth) == dataclasses.asdict(j_auth)
    assert t_auth.pubkey == TSn.decompress_jubjub(pub)
    assert t_auth.randomizer == TSn.decompress_jubjub(rpt) and t_auth.s == 0x1D
    assert t_auth.msg_words[:4] == [3, 0xAA, 0xA9059CBB, int.from_bytes(data[4:36], "big")]
    assert t_auth.msg_words[4] == int.from_bytes(data[36:] + bytes(12), "big")
    assert len(t_auth.msg_words) == 32 and t_auth.msg_words[5:] == [0] * 27


# ---------------------------------------------------------------------------
# the copies' code, where no input built here reaches
# ---------------------------------------------------------------------------

COPIES = ["frontend/__init__.py", "frontend/merkle.py", "frontend/r1cs_eval.py",
          "frontend/snapshot.py", "frontend/synthesizer.py", "frontend/wasm_vm.py",
          "frontend/witness_calculator.py", "frontend/witness_gen.py", "host/reference.py",
          "models/witness_solver.py", "testing/real_fixture.py"]
REAL_FIXTURE_BUILDERS = ("build_real_tx_fixture", "build_real_fixture")


def _tree(pkg, rel):
    tree = ast.parse((ROOT / pkg / rel).read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and body
                and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


def _library_default(tree, port):
    """Take out the allowed difference of `testing/real_fixture.py`; ->
    what was taken out, as source text."""
    taken = []
    keep = []
    for stmt in tree.body:
        if (not port and isinstance(stmt, ast.Assign)
                and stmt.targets[0].id == "REFERENCE_LIBRARY") or (
                port and isinstance(stmt, ast.ImportFrom)
                and stmt.module == "io.subcircuit_library"):
            taken.append(ast.unparse(stmt).split("\n")[0])
        else:
            keep.append(stmt)
    tree.body = keep
    for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef)
               and n.name in REAL_FIXTURE_BUILDERS):
        arg = fn.args.args[0]
        default = fn.args.defaults[0]
        taken.append(f"{fn.name}({ast.unparse(arg)} = {ast.unparse(default)})")
        arg.annotation, fn.args.defaults[0] = None, ast.Constant(None)
        if port:
            first = fn.body[1] if isinstance(fn.body[0], ast.ImportFrom) else fn.body[0]
            taken.append(ast.unparse(first))
            fn.body.remove(first)
    return taken


@pytest.mark.parametrize("rel", COPIES)
def test_copy_code_equals_jax_module(rel):
    t, j = _tree("tokamak_zk_evm_tpu_torch", rel), _tree("tokamak_zk_evm_tpu", rel)
    if rel == "testing/real_fixture.py":
        taken = _library_default(j, port=False)
        assert taken[0].startswith("REFERENCE_LIBRARY = '/") and taken[0].endswith(
            "/packages/frontend/qap-compiler/subcircuits/library'")
        assert taken[1:] == ["build_real_tx_fixture(library_dir: str = REFERENCE_LIBRARY)",
                             "build_real_fixture(library_dir: str = REFERENCE_LIBRARY)"]
        assert _library_default(t, port=True) == [
            "from ..io.subcircuit_library import resolve_library_path",
            "build_real_tx_fixture(library_dir: str | None = None)",
            "library_dir = resolve_library_path(library_dir)",
            "build_real_fixture(library_dir: str | None = None)",
            "library_dir = resolve_library_path(library_dir)"]
    assert ast.dump(t) == ast.dump(j)
