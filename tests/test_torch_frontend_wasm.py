"""The port's WASM translator and circom calculator against the JAX package's.

The repo ships no `.wasm` file, so a small binary encoder here assembles
modules inside `frontend/wasm_vm.py`'s scope (type, import, function,
table, memory, export, elem, data and code sections):

* i32 / i64 arithmetic with signed division and remainder, shifts,
  rotates, clz / ctz / popcnt, comparisons, wraps and sign extensions, on
  edge words and random ones;
* block / loop / if with br, br_if and br_table, select, return;
* call, call_indirect through an elem-filled table, an imported function,
  memory loads and stores of every width over a data segment, and
  memory.size / memory.grow.

Both translators must return the same results, equal to Python-int
expectations, and both must refuse an f32 opcode with `WasmError`.  One
module implements circom's calculator ABI (the exports
`frontend/witness_calculator.WitnessCalculator` calls, FNV-1a signal
hashes) for a two-input circuit with a binary hint wire that the compiled
R1CS schedule cannot cover (both packages raise `UncompilableR1CS` on it,
and both solvers zero the hint): placed at `wasm/subcircuit0.wasm` in a staged
toy library, `SubcircuitCalculators` and `WitnessGenerator`'s exact engine
must give the JAX package's witness.  Tolerance: exact.
"""

import os

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.frontend import r1cs_eval as JR
from tokamak_zk_evm_tpu.frontend import wasm_vm as JV
from tokamak_zk_evm_tpu.frontend import witness_calculator as JC
from tokamak_zk_evm_tpu.frontend import witness_gen as JWG
from tokamak_zk_evm_tpu.io import artifacts as JA
from tokamak_zk_evm_tpu.models import witness_solver as JS
from tokamak_zk_evm_tpu_torch.fields import R_MOD
from tokamak_zk_evm_tpu_torch.frontend import r1cs_eval as TR
from tokamak_zk_evm_tpu_torch.frontend import wasm_vm as TV
from tokamak_zk_evm_tpu_torch.frontend import witness_calculator as TC
from tokamak_zk_evm_tpu_torch.frontend import witness_gen as TWG
from tokamak_zk_evm_tpu_torch.io import artifacts as TA
from tokamak_zk_evm_tpu_torch.models import witness_solver as TS
from tokamak_zk_evm_tpu_torch.models.protocol import SubcircuitInfo, SubcircuitR1CS
from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture

torch.set_num_threads(1)

I32, I64 = 0x7F, 0x7E
M32, M64 = (1 << 32) - 1, (1 << 64) - 1

# ---------------------------------------------------------------------------
# a minimal WASM binary encoder
# ---------------------------------------------------------------------------


def uleb(n):
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def sleb(n):
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        if (n == 0 and not b & 0x40) or (n == -1 and b & 0x40):
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def vec(items):
    return uleb(len(items)) + b"".join(items)


def name(s):
    return uleb(len(s.encode())) + s.encode()


def section(sid, payload):
    return bytes([sid]) + uleb(len(payload)) + payload


def i32c(v):
    v &= M32
    return b"\x41" + sleb(v - (1 << 32) if v >> 31 else v)


def i64c(v):
    v &= M64
    return b"\x42" + sleb(v - (1 << 64) if v >> 63 else v)


def get(i):
    return b"\x20" + uleb(i)


def put(i):
    return b"\x21" + uleb(i)


def tee(i):
    return b"\x22" + uleb(i)


def block(bt=0x40):
    return bytes([0x02, bt])


def loop(bt=0x40):
    return bytes([0x03, bt])


def if_(bt=0x40):
    return bytes([0x04, bt])


ELSE, END, RETURN, SELECT, DROP = b"\x05", b"\x0b", b"\x0f", b"\x1b", b"\x1a"


def br(d):
    return b"\x0c" + uleb(d)


def br_if(d):
    return b"\x0d" + uleb(d)


def br_table(depths, default):
    return b"\x0e" + vec([uleb(d) for d in depths]) + uleb(default)


def call(f):
    return b"\x10" + uleb(f)


def call_indirect(t):
    return b"\x11" + uleb(t) + b"\x00"


def mem(op, offset=0):
    return bytes([op]) + uleb(0) + uleb(offset)


def op(*codes):
    return bytes(codes)


class Asm:
    """Sections of one module; functions are numbered after the imports."""

    def __init__(self, mem_pages=None, table=0):
        self.types, self.imports, self.funcs, self.exports = [], [], [], []
        self.elems, self.datas = [], []
        self.mem_pages, self.table = mem_pages, table

    def type(self, params, results):
        t = (tuple(params), tuple(results))
        if t not in self.types:
            self.types.append(t)
        return self.types.index(t)

    def import_func(self, module, field, params, results):
        assert not self.funcs
        self.imports.append((module, field, self.type(params, results)))
        return len(self.imports) - 1

    def func(self, params, results, body, locals_=(), export=None):
        idx = len(self.imports) + len(self.funcs)
        self.funcs.append((self.type(params, results), list(locals_), body))
        if export:
            self.exports.append((export, idx))
        return idx

    def encode(self):
        out = b"\0asm\x01\0\0\0"
        out += section(1, vec([b"\x60" + vec([bytes([p]) for p in ps])
                               + vec([bytes([r]) for r in rs]) for ps, rs in self.types]))
        if self.imports:
            out += section(2, vec([name(m) + name(f) + b"\x00" + uleb(t)
                                   for m, f, t in self.imports]))
        out += section(3, vec([uleb(t) for t, _, _ in self.funcs]))
        if self.table:
            out += section(4, vec([b"\x70\x00" + uleb(self.table)]))
        if self.mem_pages is not None:
            out += section(5, vec([b"\x00" + uleb(self.mem_pages)]))
        out += section(7, vec([name(n) + b"\x00" + uleb(i) for n, i in self.exports]))
        if self.elems:
            out += section(9, vec([uleb(0) + i32c(off) + END + vec([uleb(f) for f in fs])
                                   for off, fs in self.elems]))
        bodies = []
        for _, locals_, body in self.funcs:
            content = vec([uleb(1) + bytes([t]) for t in locals_]) + body + END
            bodies.append(uleb(len(content)) + content)
        out += section(10, vec(bodies))
        if self.datas:
            out += section(11, vec([uleb(0) + i32c(off) + END + uleb(len(d)) + d
                                    for off, d in self.datas]))
        return out


def both(code, imports=None):
    """(port instance, JAX instance) of one module."""
    return TV.Instance(code, imports or {}), JV.Instance(code, imports or {})


def run(insts, fn, *args):
    t, j = (inst.exports[fn](*args) for inst in insts)
    assert t == j, (fn, args, t, j)
    return t


# ---------------------------------------------------------------------------
# integer arithmetic
# ---------------------------------------------------------------------------


def sgn(v, bits):
    return v - (1 << bits) if v >> (bits - 1) else v


def tdiv(a, b):
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def rot(a, b, bits, left):
    r = b % bits
    m = (1 << bits) - 1
    if not left:
        r = (bits - r) % bits
    return ((a << r) | (a >> (bits - r))) & m if r else a


def binops(bits):
    m, s = (1 << bits) - 1, lambda v: sgn(v, bits)
    return {
        "add": lambda a, b: (a + b) & m,
        "sub": lambda a, b: (a - b) & m,
        "mul": lambda a, b: (a * b) & m,
        "div_s": lambda a, b: tdiv(s(a), s(b)) & m,
        "div_u": lambda a, b: a // b,
        "rem_s": lambda a, b: (s(a) - s(b) * tdiv(s(a), s(b))) & m,
        "rem_u": lambda a, b: a % b,
        "and": lambda a, b: a & b,
        "or": lambda a, b: a | b,
        "xor": lambda a, b: a ^ b,
        "shl": lambda a, b: (a << (b % bits)) & m,
        "shr_s": lambda a, b: (s(a) >> (b % bits)) & m,
        "shr_u": lambda a, b: a >> (b % bits),
        "rotl": lambda a, b: rot(a, b, bits, True),
        "rotr": lambda a, b: rot(a, b, bits, False),
        "eq": lambda a, b: int(a == b),
        "ne": lambda a, b: int(a != b),
        "lt_s": lambda a, b: int(s(a) < s(b)),
        "lt_u": lambda a, b: int(a < b),
        "gt_s": lambda a, b: int(s(a) > s(b)),
        "gt_u": lambda a, b: int(a > b),
        "le_s": lambda a, b: int(s(a) <= s(b)),
        "le_u": lambda a, b: int(a <= b),
        "ge_s": lambda a, b: int(s(a) >= s(b)),
        "ge_u": lambda a, b: int(a >= b),
    }


# opcodes in `binops` order: arithmetic, then comparisons
BIN_OPS = {32: list(range(0x6A, 0x79)) + list(range(0x46, 0x50)),
           64: list(range(0x7C, 0x8B)) + list(range(0x51, 0x5B))}


def unops():
    def clz(v, bits):
        return bits - v.bit_length()

    def ctz(v, bits):
        return (v & -v).bit_length() - 1 if v else bits

    def sx(v, from_bits, to_bits):
        return sgn(v & ((1 << from_bits) - 1), from_bits) & ((1 << to_bits) - 1)

    return {  # name: (opcode, param type, result type, expectation)
        "i32.eqz": (0x45, I32, I32, lambda v: int(v == 0)),
        "i64.eqz": (0x50, I64, I32, lambda v: int(v == 0)),
        "i32.clz": (0x67, I32, I32, lambda v: clz(v, 32)),
        "i32.ctz": (0x68, I32, I32, lambda v: ctz(v, 32)),
        "i32.popcnt": (0x69, I32, I32, lambda v: bin(v).count("1")),
        "i64.clz": (0x79, I64, I64, lambda v: clz(v, 64)),
        "i64.ctz": (0x7A, I64, I64, lambda v: ctz(v, 64)),
        "i64.popcnt": (0x7B, I64, I64, lambda v: bin(v).count("1")),
        "i32.wrap_i64": (0xA7, I64, I32, lambda v: v & M32),
        "i64.extend_i32_s": (0xAC, I32, I64, lambda v: sgn(v, 32) & M64),
        "i64.extend_i32_u": (0xAD, I32, I64, lambda v: v),
        "i32.extend8_s": (0xC0, I32, I32, lambda v: sx(v, 8, 32)),
        "i32.extend16_s": (0xC1, I32, I32, lambda v: sx(v, 16, 32)),
        "i64.extend8_s": (0xC2, I64, I64, lambda v: sx(v, 8, 64)),
        "i64.extend16_s": (0xC3, I64, I64, lambda v: sx(v, 16, 64)),
        "i64.extend32_s": (0xC4, I64, I64, lambda v: sx(v, 32, 64)),
    }


def words(rng, bits, n):
    m = (1 << bits) - 1
    edge = [0, 1, 2, m, m - 1, 1 << (bits - 1), (1 << (bits - 1)) - 1, 0x80, 0xFF, 0x8000]
    return edge + [int.from_bytes(rng.bytes(bits // 8), "little") for _ in range(n)]


@pytest.mark.parametrize("bits", [32, 64])
def test_integer_binops_match_jax_and_python(bits):
    t = I32 if bits == 32 else I64
    asm = Asm()
    cases = binops(bits)
    for (nm, _), code in zip(cases.items(), BIN_OPS[bits]):
        res = I32 if code < 0x6A else t  # comparisons give an i32
        asm.func([t, t], [res], get(0) + get(1) + op(code), export=nm)
    insts = both(asm.encode())
    rng = np.random.default_rng(bits)
    vals = words(rng, bits, 12)
    m = (1 << bits) - 1
    int_min = 1 << (bits - 1)
    for a in vals:
        for b in vals + [bits + 3, 2 * bits - 1]:
            for nm, want in cases.items():
                if nm in ("div_s", "div_u", "rem_s", "rem_u") and (
                        b == 0 or (nm == "div_s" and a == int_min and b == m)):
                    continue  # traps in WASM
                assert run(insts, nm, a & m, b & m) == want(a & m, b & m), (nm, a, b)


def test_integer_unops_match_jax_and_python():
    asm = Asm()
    for nm, (code, p, r, _) in unops().items():
        asm.func([p], [r], get(0) + op(code), export=nm)
    insts = both(asm.encode())
    rng = np.random.default_rng(5)
    for nm, (_, p, _, want) in unops().items():
        bits = 32 if p == I32 else 64
        for v in words(rng, bits, 8):
            v &= (1 << bits) - 1
            assert run(insts, nm, v) == want(v), (nm, v)


def test_constants_and_select_match_jax():
    asm = Asm()
    for k, v in enumerate((0, 1, -1, 63, 64, -65, 1 << 31, (1 << 31) - 1, 12345678)):
        asm.func([], [I32], i32c(v), export=f"c32_{k}")
    for k, v in enumerate((0, -1, 1 << 63, (1 << 63) - 1, 0x123456789ABCDEF0)):
        asm.func([], [I64], i64c(v), export=f"c64_{k}")
    asm.func([I32, I32, I32], [I32], get(0) + get(1) + get(2) + SELECT, export="select")
    insts = both(asm.encode())
    for k, v in enumerate((0, 1, -1, 63, 64, -65, 1 << 31, (1 << 31) - 1, 12345678)):
        assert run(insts, f"c32_{k}") == v & M32
    for k, v in enumerate((0, -1, 1 << 63, (1 << 63) - 1, 0x123456789ABCDEF0)):
        assert run(insts, f"c64_{k}") == v & M64
    assert run(insts, "select", 7, 9, 1) == 7 and run(insts, "select", 7, 9, 0) == 9


# ---------------------------------------------------------------------------
# control flow
# ---------------------------------------------------------------------------


def control_module():
    asm = Asm()
    # sum 1..n: block / loop / br_if out / br back
    asm.func([I32], [I32], (
        block() + loop()
        + get(2) + get(0) + op(0x4F) + br_if(1)
        + get(2) + i32c(1) + op(0x6A) + put(2)
        + get(1) + get(2) + op(0x6A) + put(1)
        + br(0) + END + END + get(1)), locals_=[I32, I32], export="sum_to")
    # br_table over three cases and a default, each case returning
    asm.func([I32], [I32], (
        block() + block() + block() + block()
        + get(0) + br_table([0, 1, 2], 3) + END
        + i32c(10) + RETURN + END
        + i32c(20) + RETURN + END
        + i32c(30) + RETURN + END
        + i32c(40)), export="classify")
    # if / else with a result
    asm.func([I32], [I32], (
        get(0) + i32c(5) + op(0x4B) + if_(I32)
        + get(0) + i32c(2) + op(0x6C) + ELSE
        + get(0) + i32c(100) + op(0x6A) + END), export="branch")
    # the first k with k * k > x: a br 2 out of an if inside a loop
    asm.func([I32], [I32], (
        block() + loop()
        + get(1) + get(1) + op(0x6C) + get(0) + op(0x4B) + if_() + br(2) + END
        + get(1) + i32c(1) + op(0x6A) + put(1)
        + br(0) + END + END + get(1)), locals_=[I32], export="isqrt_up")
    # popcount by clearing the lowest bit: br_if out on eqz
    asm.func([I32], [I32], (
        block() + loop()
        + get(0) + op(0x45) + br_if(1)
        + get(0) + get(0) + i32c(1) + op(0x6B) + op(0x71) + put(0)
        + get(1) + i32c(1) + op(0x6A) + put(1)
        + br(0) + END + END + get(1)), locals_=[I32], export="bits")
    # a block with a result left by br_if, and local.tee
    asm.func([I32], [I32], (
        block(I32) + i32c(111) + get(0) + op(0x45) + br_if(0) + DROP
        + get(0) + tee(1) + get(1) + op(0x6C) + END), locals_=[I32], export="sq_or_111")
    return asm.encode()


def test_control_flow_matches_jax_and_python():
    insts = both(control_module())
    for n in (0, 1, 2, 10, 1000, 70000):
        assert run(insts, "sum_to", n) == n * (n + 1) // 2 & M32
    for x in (0, 1, 2, 3, 4, 1 << 31, M32):
        assert run(insts, "classify", x) == {0: 10, 1: 20, 2: 30}.get(x, 40)
    for x in (0, 5, 6, 1000):
        assert run(insts, "branch", x) == (x * 2 if x > 5 else x + 100)
    for x in (0, 1, 3, 4, 99, 100, 65535):
        assert run(insts, "isqrt_up", x) == next(k for k in range(1000) if k * k > x)
    for x in (0, 1, 0xFF, 0x80000001, M32):
        assert run(insts, "bits", x) == bin(x).count("1")
    for x in (0, 3, 0xFFFF):
        assert run(insts, "sq_or_111", x) == (111 if x == 0 else x * x & M32)


# ---------------------------------------------------------------------------
# calls, tables, imports and memory
# ---------------------------------------------------------------------------

DATA = bytes([0x01, 0x02, 0x03, 0x04, 0xFF, 0xFE, 0x80, 0x7F, 0x11, 0x22, 0x33, 0x44])
LOADS = {  # name: (opcode, result type, width, signed)
    "i32.load": (0x28, I32, 4, False), "i64.load": (0x29, I64, 8, False),
    "i32.load8_s": (0x2C, I32, 1, True), "i32.load8_u": (0x2D, I32, 1, False),
    "i32.load16_s": (0x2E, I32, 2, True), "i32.load16_u": (0x2F, I32, 2, False),
    "i64.load8_s": (0x30, I64, 1, True), "i64.load8_u": (0x31, I64, 1, False),
    "i64.load16_s": (0x32, I64, 2, True), "i64.load16_u": (0x33, I64, 2, False),
    "i64.load32_s": (0x34, I64, 4, True), "i64.load32_u": (0x35, I64, 4, False),
}
STORES = {"i32.store": (0x36, I32, 4), "i64.store": (0x37, I64, 8), "i32.store8": (0x3A, I32, 1),
          "i32.store16": (0x3B, I32, 2), "i64.store8": (0x3C, I64, 1),
          "i64.store16": (0x3D, I64, 2), "i64.store32": (0x3E, I64, 4)}


def memory_module():
    asm = Asm(mem_pages=1, table=4)
    mul3 = asm.import_func("env", "mul3", [I32], [I32])
    sq = asm.func([I32], [I32], get(0) + get(0) + op(0x6C))
    add1 = asm.func([I32], [I32], get(0) + i32c(1) + op(0x6A))
    dbl = asm.func([I32], [I32], get(0) + i32c(1) + op(0x74))
    asm.elems.append((0, [add1, dbl, sq, mul3]))
    asm.func([I32], [I32], get(0) + call(sq) + get(0) + call(mul3) + op(0x6A), export="call")
    asm.func([I32, I32], [I32], get(1) + get(0) + call_indirect(asm.type([I32], [I32])),
             export="indirect")
    for nm, (code, res, _, _) in LOADS.items():
        asm.func([I32], [res], get(0) + mem(code, 16), export=nm)
    for nm, (code, t, _) in STORES.items():
        asm.func([I32, t], [], get(0) + get(1) + mem(code), export=nm)
    asm.func([], [I32], b"\x3f\x00", export="size")
    asm.func([I32], [I32], get(0) + b"\x40\x00", export="grow")
    asm.datas.append((16, DATA))
    return asm.encode()


def test_calls_tables_and_imports_match_jax():
    insts = both(memory_module(), {"env": {"mul3": lambda v: v * 3 & M32}})
    for x in (0, 7, 1 << 20, M32):
        assert run(insts, "call", x) == (x * x + 3 * x) & M32
        for i, f in enumerate((lambda v: v + 1, lambda v: 2 * v, lambda v: v * v,
                               lambda v: 3 * v)):
            assert run(insts, "indirect", i, x) == f(x) & M32
    with pytest.raises(TV.WasmError, match="missing import env.mul3"):
        TV.Instance(memory_module(), {})
    with pytest.raises(JV.WasmError, match="missing import env.mul3"):
        JV.Instance(memory_module(), {})


def test_memory_matches_jax_and_python():
    insts = both(memory_module(), {"env": {"mul3": lambda v: v}})
    model = bytearray(65536)
    model[16:16 + len(DATA)] = DATA

    def check_loads():
        for a in range(0, 24):
            for nm, (_, res, width, signed) in LOADS.items():
                v = int.from_bytes(model[a + 16:a + 16 + width], "little")
                if signed:
                    v = sgn(v, 8 * width)
                assert run(insts, nm, a) == v & (M32 if res == I32 else M64), (nm, a)

    check_loads()
    rng = np.random.default_rng(3)
    for nm, (_, t, width) in STORES.items():
        a = int(rng.integers(0, 40))
        v = int(rng.integers(0, 1 << 62)) << 2 | 3
        v &= M32 if t == I32 else M64
        assert run(insts, nm, a, v) is None
        model[a:a + width] = (v & ((1 << 8 * width) - 1)).to_bytes(width, "little")
        check_loads()
    assert run(insts, "size") == 1
    assert run(insts, "grow", 2) == 1
    assert run(insts, "size") == 3
    assert run(insts, "i64.store", 3 * 65536 - 8, 0x0102030405060708) is None
    assert run(insts, "i32.load", 3 * 65536 - 4 - 16) == 0x01020304
    assert insts[0].memory == insts[1].memory


def test_float_opcode_refused_by_both():
    asm = Asm()
    asm.func([], [], b"\x43" + bytes(4) + DROP, export="f")  # f32.const 0.0
    code = asm.encode()
    for mod in (TV, JV):
        with pytest.raises(mod.WasmError, match="unsupported opcode 0x43"):
            mod.Instance(code, {})


# ---------------------------------------------------------------------------
# circom's calculator ABI on an assembled module
# ---------------------------------------------------------------------------


def fnv1a_64(s):
    h = 0xCBF29CE484222325
    for ch in s.encode():
        h = ((h ^ ch) * 0x100000001B3) & M64
    return h


def calculator_module():
    """Circuit wires [1, out1, out2, in1, in2, h] of `hint_circuit()`: the
    outputs copy the inputs, the hint is 0.  Memory: the shared RW buffer
    (8 words) at 0, the input signals at 64 + 32 i, the prime at 1024, the
    constant one at 1056, zeros at 1088."""
    asm = Asm(mem_pages=1)
    exc = asm.import_func("runtime", "exceptionHandler", [I32], [])
    for f in ("printErrorMessage", "writeBufferMessage", "showSharedRWMemory"):
        asm.import_func("runtime", f, [], [])
    h = fnv1a_64("in")
    hm, hl = h >> 32, h & M32
    is_in = get(0) + i32c(hm) + op(0x46) + get(1) + i32c(hl) + op(0x46) + op(0x71)

    def copy8(src, dst):  # 8 words from address local `src` to `dst` + 4 k
        return (i32c(0) + put(3) + block() + loop()
                + get(3) + i32c(8) + op(0x4F) + br_if(1)
                + get(dst) + get(3) + i32c(2) + op(0x74) + op(0x6A)
                + get(src) + get(3) + i32c(2) + op(0x74) + op(0x6A) + mem(0x28)
                + mem(0x36)
                + get(3) + i32c(1) + op(0x6A) + put(3)
                + br(0) + END + END)

    asm.func([], [I32], i32c(8), export="getFieldNumLen32")
    asm.func([], [], i32c(1024) + put(0) + i32c(0) + put(1) + copy8(0, 1),
             locals_=[I32, I32, I32, I32], export="getRawPrime")
    asm.func([I32], [I32], get(0) + i32c(2) + op(0x74) + mem(0x28), export="readSharedRWMemory")
    asm.func([I32, I32], [], get(0) + i32c(2) + op(0x74) + get(1) + mem(0x36),
             export="writeSharedRWMemory")
    asm.func([], [I32], i32c(6), export="getWitnessSize")
    asm.func([], [I32], i32c(2), export="getVersion")
    asm.func([], [I32], i32c(2), export="getInputSize")
    asm.func([], [I32], i32c(0), export="getMessageChar")
    asm.func([I32], [], i32c(512) + i32c(0) + mem(0x36), export="init")
    asm.func([I32, I32], [I32], is_in + if_(I32) + i32c(2) + ELSE + i32c(-1) + END,
             export="getInputSignalSize")
    # setInputSignal(hm, hl, i): the shared buffer -> input signal i
    asm.func([I32, I32, I32], [], (
        is_in + op(0x45) + if_() + i32c(1) + call(exc) + END
        + i32c(0) + put(4) + get(2) + i32c(5) + op(0x74) + i32c(64) + op(0x6A) + put(5)
        + copy8(4, 5)), locals_=[I32, I32, I32], export="setInputSignal")
    # getWitness(i): pick the source by br_table, then copy it to the buffer
    asm.func([I32], [], (
        i32c(1088) + put(1)
        + block() + block() + block() + block()
        + get(0) + br_table([0, 1, 2, 1, 2], 3) + END
        + i32c(1056) + put(1) + br(2) + END
        + i32c(64) + put(1) + br(1) + END
        + i32c(96) + put(1) + br(0) + END
        + i32c(0) + put(2) + copy8(1, 2)), locals_=[I32, I32, I32], export="getWitness")
    asm.datas.append((1024, R_MOD.to_bytes(32, "little") + (1).to_bytes(32, "little")))
    return asm.encode()


def hint_circuit():
    """wires [1, out1, out2, in1, in2, h]: out_i - in_i = 0 and h (h - 1) =
    0.  `h` is a binary hint no row determines (circom leaves such a hint
    0), so `r1cs_eval` cannot compile the subcircuit."""
    neg1 = R_MOD - 1
    r1cs = SubcircuitR1CS(
        A_cols={1: [(0, 1)], 3: [(0, neg1)], 2: [(1, 1)], 4: [(1, neg1)], 5: [(2, 1)]},
        B_cols={0: [(0, 1), (1, 1), (2, neg1)], 5: [(2, 1)]},
        C_cols={},
    )
    return r1cs, SubcircuitInfo(0, "hint", 6, (1, 2), (3, 2), [4, 0, 1, 5, 6, 20])


def test_uncompilable_r1cs_from_both():
    r1cs, info = hint_circuit()
    msgs = []
    for mod in (TR, JR):
        with pytest.raises(mod.UncompilableR1CS) as e:
            mod.compile_subcircuit(r1cs, info)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    known = {0: 1, 3: 5, 4: 7}
    assert TS.solve_r1cs_witness(r1cs, 6, dict(known)) == \
        JS.solve_r1cs_witness(r1cs, 6, dict(known)) == [1, 5, 7, 5, 7, 0]


def test_calculator_abi_matches_jax():
    code = calculator_module()
    rng = np.random.default_rng(21)
    calcs = TC.WitnessCalculator(code), JC.WitnessCalculator(code)
    for c in calcs:
        assert (c.n32, c.prime, c.witness_size, c.version) == (8, R_MOD, 6, 2)
    for _ in range(3):
        a, b = (int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(2))
        got = [c.calculate_witness({"in": [a, b + R_MOD]}) for c in calcs]
        assert got[0] == got[1] == [1, a, b, a, b, 0]
    for c, err in zip(calcs, (TC.WitnessCalcError, JC.WitnessCalcError)):
        with pytest.raises(err, match="signal x not found"):
            c.calculate_witness({"x": [1, 2]})
        with pytest.raises(err, match="got 1 values, circuit wants 2"):
            c.calculate_witness({"in": [1]})


@pytest.fixture(scope="module")
def toy_library(tmp_path_factory):
    """The toy fixture's library with subcircuit 0 swapped for the hint
    circuit, and the calculator at wasm/subcircuit0.wasm."""
    fx = build_fixture()
    r1cs, info = hint_circuit()
    lib = str(tmp_path_factory.mktemp("wasm_library"))
    TA.save_library(lib, fx.params, [info] + fx.infos[1:], [r1cs] + fx.library[1:])
    os.makedirs(os.path.join(lib, "wasm"))
    with open(os.path.join(lib, "wasm", "subcircuit0.wasm"), "wb") as f:
        f.write(calculator_module())
    return lib, fx


def test_subcircuit_calculators_take_the_wasm_route(toy_library):
    lib, fx = toy_library
    t, j = TC.SubcircuitCalculators(lib), JC.SubcircuitCalculators(lib)
    assert t.available() and j.available()
    assert t.witness(0, [5, 7]) == j.witness(0, [5, 7]) == [1, 5, 7, 5, 7, 0]
    assert t._compiled_for(0) is False and j._compiled_for(0) is False
    for p in fx.placements[1:]:  # no module for these: the compiled schedule
        i0, ic = fx.infos[p.subcircuit_id].In_idx
        ins = p.variables[i0:i0 + ic]
        assert t.witness(p.subcircuit_id, ins) == j.witness(p.subcircuit_id, ins) == p.variables
    with pytest.raises(TV.WasmError, match="no wasm module"):
        t.get(1)


def test_witness_generator_exact_engine_matches_jax(toy_library):
    lib, fx = toy_library
    (_, t_infos, t_lib), (_, j_infos, j_lib) = TA.load_library(lib), JA.load_library(lib)
    tg, jg = TWG.WitnessGenerator(lib, t_infos, t_lib), JWG.WitnessGenerator(lib, j_infos, j_lib)
    assert tg.has_exact(0) and jg.has_exact(0) and not tg.has_exact(1)
    want = [1, 11, 13, 11, 13, 0]
    assert tg.witness(0, [11, 13], out_values=[11, 13]) == \
        jg.witness(0, [11, 13], out_values=[11, 13]) == want
    for p in fx.placements[1:]:  # the solver engine
        i0, ic = fx.infos[p.subcircuit_id].In_idx
        ins = p.variables[i0:i0 + ic]
        assert tg.witness(p.subcircuit_id, ins) == jg.witness(p.subcircuit_id, ins) == p.variables
    msgs = []
    for gen, err in ((TWG.WitnessGenerator(lib, t_infos, t_lib), TWG.WitnessGenError),
                     (JWG.WitnessGenerator(lib, j_infos, j_lib), JWG.WitnessGenError)):
        with pytest.raises(err) as e:
            gen.witness(0, [11, 13], out_values=[11, 14])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
