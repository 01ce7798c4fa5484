"""B13's add and doubling kernels (`backend/csrc/g1_ops.cu`, their arithmetic
in `g1_lazy.cuh`), modelled on the CPU.

The kernels have no interpret mode, so what they do is written out here and
held against the plain versions, the JAX package and host integers:

  * the tiling: thread t of block b owns lane b T + t, loads limbs 2k and
    2k + 1 of each coordinate of P at that lane and of Q at its broadcast
    lane into word k of its shared-memory slots, and stores the output limbs
    of its lane; at small block sizes, with a ragged last block and Q
    broadcast, every lane is written exactly once, every read is in range,
    and no two threads of a warp touch one bank;
  * the programs (`G1_ADD_PROGRAM`, `G1_DBL_PROGRAM`, read from the header)
    on Python ints with the kernels' arithmetic: values in [0, 2q) between
    steps, Montgomery products with no final subtract (each CIOS row and
    each reduction word of the squaring checked against the bound the CUDA
    code assumes), adds and subtracts modulo 2q, one reduction at the end;
    the lane logic (infinite operands, P + P, P + (-P)) on top, against
    `plain_g1_add` / `plain_g1_dbl` and the JAX package's `jac_add` /
    `jac_double`, on planted values (0, 1, q - 1, near 2q, raw infinities,
    Y = 0) and seeded points;
  * the header's arithmetic itself, compiled with g++ (the PTX carry
    primitives of `fq_chain.cuh` replaced by C over one carry flag, the CUDA
    intrinsics by their definitions) and held word for word to the model;
  * the constants of the sources.

Tolerance: exact.
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.ops import curve as JC
from tokamak_zk_evm_tpu_torch.backend import kernels as K
from tokamak_zk_evm_tpu_torch.fields import Q_MOD
from tokamak_zk_evm_tpu_torch.host.curve import G1, g1_scalar_mul_affine
from tokamak_zk_evm_tpu_torch.ops import curve as TC

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(K.__file__), "csrc")
q = Q_MOD
R = 1 << 384
M32 = (1 << 32) - 1
N0 = (-pow(q, -1, 1 << 32)) % (1 << 32)
QINV = pow(q, -1, R)
ONE = R % q


def read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def program(name):
    """[(op, d, a, b)] of a program macro of g1_lazy.cuh."""
    src = read("g1_lazy.cuh")
    start = src.index(f"#define {name}")
    body = []
    for line in src[start:].splitlines():
        body.append(line)
        if not line.rstrip().endswith("\\"):
            break
    return [(op, int(d), int(a), int(b)) for op, d, a, b in
            re.findall(r"\{fql::(\w+),\s*(\d+),\s*(\d+),\s*(\d+)\}", "\n".join(body))]


def constant(src, name):
    return int(re.search(rf"{name}\s*=\s*(\d+)", src).group(1))


ADD_PROG, DBL_PROG = program("G1_ADD_PROGRAM"), program("G1_DBL_PROGRAM")
LAZY = read("g1_lazy.cuh")
SLOTS = {k: constant(LAZY, k) for k in ("ADD_SLOTS", "ADD_X3", "ADD_Y3", "ADD_Z3", "ADD_H",
                                        "ADD_R", "DBL_SLOTS", "DBL_X3", "DBL_Y3", "DBL_Z3")}


# --- the arithmetic on ints --------------------------------------------------


def mont(a, b):
    """CIOS a b R^-1 without the final subtract, row by row as `fql::mul`
    runs it: each row's partial sum is held below a + q (< 2^383, so the
    even and odd halves of 12 words each never overflow)."""
    assert 0 <= a < 2 * q and 0 <= b < 2 * q
    t = 0
    for i in range(12):
        t += a * ((b >> (32 * i)) & M32)
        m = (t & M32) * N0 & M32
        t = (t + m * q) >> 32
        assert t < a + q < 1 << 383
    assert t == (a * b + ((-a * b * QINV) % R) * q) // R and t < 2 * q
    return t


def mont_sqr(a):
    """`fql::sqr`: the 24-word square, reduced a word at a time; the sum
    stays below 2^768 and the result below 2q."""
    assert 0 <= a < 2 * q
    t = a * a
    for i in range(12):
        m = ((t >> (32 * i)) & M32) * N0 & M32
        t += (m * q) << (32 * i)
        assert t < 1 << 768
    t >>= 384
    assert t == mont(a, a) and t < 2 * q
    return t


def add2(a, b):
    assert 0 <= a < 2 * q and 0 <= b < 2 * q
    t = a + b
    return t - 2 * q if t >= 2 * q else t


def sub2(a, b):
    assert 0 <= a < 2 * q and 0 <= b < 2 * q
    return a - b + 2 * q if a < b else a - b


def reduce(a):
    assert 0 <= a < 2 * q
    return a - q if a >= q else a


def zero_mod(a):
    return a == 0 or a == q


OPS = {"MUL": mont, "SQR": lambda a, _: mont_sqr(a), "ADD": add2, "SUB": sub2}


def run(slots, prog):
    for op, d, a, b in prog:
        slots[d] = OPS[op](slots[a], slots[b] if op != "SQR" else None)
        assert 0 <= slots[d] < 2 * q


def model_add(P, Q):
    """One lane of g1_add_kernel: P, Q (X, Y, Z) ints below q (Montgomery
    words), -> the output ints, or P / Q as they are."""
    if P[2] == 0:
        return Q
    if Q[2] == 0:
        return P
    s = list(P) + list(Q) + [None] * (SLOTS["ADD_SLOTS"] - 6)
    run(s, ADD_PROG)
    if not zero_mod(s[SLOTS["ADD_H"]]):
        return tuple(reduce(s[SLOTS[k]]) for k in ("ADD_X3", "ADD_Y3", "ADD_Z3"))
    if not zero_mod(s[SLOTS["ADD_R"]]):
        return (ONE, ONE, 0)
    s[:3] = P
    run(s, DBL_PROG)
    return tuple(reduce(s[SLOTS[k]]) for k in ("DBL_X3", "DBL_Y3", "DBL_Z3"))


def model_dbl(P):
    if P[2] == 0:
        return (ONE, ONE, 0)
    s = list(P) + [None] * (SLOTS["DBL_SLOTS"] - 3)
    run(s, DBL_PROG)
    return tuple(reduce(s[SLOTS[k]]) for k in ("DBL_X3", "DBL_Y3", "DBL_Z3"))


# --- inputs -------------------------------------------------------------------


def cols(p):
    """[24, B] int32 coordinate triple -> per lane (X, Y, Z) ints."""
    arrs = [x.numpy().astype(np.int64) for x in p]
    B = arrs[0].shape[1]
    return [tuple(sum(int(a[k, i]) << (16 * k) for k in range(24)) for a in arrs)
            for i in range(B)]


def limbs(lanes):
    """per lane (X, Y, Z) ints -> [24, B] int32 triple."""
    out = []
    for c in range(3):
        a = np.zeros((24, len(lanes)), np.int64)
        for i, lane in enumerate(lanes):
            v = lane[c]
            for k in range(24):
                a[k, i] = (v >> (16 * k)) & 0xFFFF
        out.append(torch.as_tensor(a.astype(np.int32)))
    return tuple(out)


def planted_pairs(seed):
    """(P, Q) jacobian [24, B] triples, Z != 1: lane i takes case i % 8 of
    P+Q, P+P, P+(-P), inf+Q, P+inf, inf+inf (raw (0, 0, 0) infinities), a
    P whose Y is 0, and P+Q with Q's Z negated twice (the same point)."""
    rng = np.random.default_rng(seed)
    base = [g1_scalar_mul_affine(G1.gen, int(k)) for k in rng.integers(1, 1 << 40, size=12)]
    a, b = [], []
    for i in range(48):
        p, qq = base[i % 12], base[(i * 5 + 1) % 12]
        case = i % 8
        a.append(None if case in (3, 5) else p)
        b.append({1: p, 2: (p[0], (-p[1]) % q), 4: None, 5: None}.get(case, qq))
    P = K.plain_g1_dbl(TC.affine_to_jac(*TC.pack_affine(a, "cpu")))
    Q = K.plain_g1_dbl(TC.affine_to_jac(*TC.pack_affine(b, "cpu")))
    lp, lq = cols(P), cols(Q)
    for i in range(6, 48, 8):  # Y = 0, off the curve: the formula's arithmetic alone
        lp[i] = (lp[i][0], 0, lp[i][2])
    raw_a = cols(TC.affine_to_jac(*TC.pack_affine(a, "cpu")))
    for i in range(3, 48, 8):  # raw (0, 0, 0) infinity in P
        lp[i] = raw_a[i]
    return limbs(lp), limbs(lq)


def extreme_lanes(seed, n):
    """Coordinates planted at 0, 1, q - 1, q - 2, R mod q and -R mod q, the
    rest random below q; Z != 0."""
    rng = np.random.default_rng(seed)
    pick = [0, 1, q - 1, q - 2, ONE, q - ONE]

    def val(i):
        r = int.from_bytes(rng.bytes(48), "little") % q
        return pick[(i // 2) % len(pick)] if i % 2 == 0 else r

    return [(val(3 * i), val(3 * i + 1), val(3 * i + 2) or 1) for i in range(n)]


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# --- the programs against the plain versions and the JAX package --------------


@pytest.mark.parametrize("seed", [1, 2])
def test_model_add_dbl_match_plain_planted(seed):
    P, Q = planted_pairs(seed)
    lp, lq = cols(P), cols(Q)
    assert same(limbs([model_add(p, x) for p, x in zip(lp, lq)]), K.plain_g1_add(P, Q))
    assert same(limbs([model_dbl(p) for p in lp]), K.plain_g1_dbl(P))


def test_model_add_broadcast_and_jax():
    """Q broadcast (rep 4, Bq not dividing B) through the model's lane
    index, against the plain version; the plain lanes against the JAX
    package's jac_add / jac_double."""
    P, Q = planted_pairs(3)
    B, Bq, rep = 48, 5, 4
    Qb = tuple(c[:, :Bq].contiguous() for c in Q)
    lp, lq = cols(P), cols(Qb)
    got = limbs([model_add(lp[i], lq[(i // rep) % Bq]) for i in range(B)])
    assert same(got, K.plain_g1_add(P, Qb, rep=rep))
    u32 = lambda t: np.asarray(t.numpy()).astype(np.uint32)  # noqa: E731
    want = JC.jac_add(tuple(u32(c) for c in P), tuple(u32(c) for c in Q))
    mine = limbs([model_add(p, x) for p, x in zip(lp, cols(Q))])
    assert all(np.array_equal(u32(m), np.asarray(w)) for m, w in zip(mine, want))
    want = JC.jac_double(tuple(u32(c) for c in P))
    assert all(np.array_equal(u32(m), np.asarray(w))
               for m, w in zip(limbs([model_dbl(p) for p in lp]), want))


def test_model_extreme_values():
    """Coordinates at 0, 1, q - 1, R mod q and random (off the curve: the
    arithmetic is total), every bound asserted, == the plain versions."""
    lanes = extreme_lanes(4, 40)
    P, Q = limbs(lanes[:20]), limbs(lanes[20:])
    assert same(limbs([model_add(p, x) for p, x in zip(lanes[:20], lanes[20:])]),
                K.plain_g1_add(P, Q))
    assert same(limbs([model_dbl(p) for p in lanes[:20]]), K.plain_g1_dbl(P))


@pytest.mark.parametrize("a", [0, 1, q - 1, q, q + 1, 2 * q - 2, 2 * q - 1])
def test_model_products_near_2q(a):
    """The products' bounds at their edges: inputs up to 2q - 1."""
    for b in (0, 1, q - 1, q, q + 7, 2 * q - 1):
        assert mont(a, b) % q == a * b * pow(R, -1, q) % q
    assert mont_sqr(a) % q == a * a * pow(R, -1, q) % q


# --- the tiling ----------------------------------------------------------------


def q_lane(i, B, Bq, rep):
    """The source's `q_lane`: 32-bit division when every size fits."""
    if Bq == B:
        return i
    if (B | Bq | rep) <= 0x7FFFFFFF:
        return ((i & M32) // (rep & M32)) % (Bq & M32)
    return (i // rep) % Bq


@pytest.mark.parametrize("B,T,Bq,rep", [(1, 32, 1, 1), (31, 32, 31, 1), (33, 32, 33, 1),
                                        (64, 32, 5, 4), (100, 64, 7, 3), (129, 64, 1, 129),
                                        (257, 128, 13, 4)])
def test_tiling_every_lane_once(B, T, Bq, rep):
    """Which thread loads and stores which lane and limb: blocks of T
    threads, thread t of block b owns lane b T + t (none past B); its
    loads of P read lane i, of Q lane q_lane(i); its slot words lie apart
    from every other thread's, and a warp's 32 accesses to one word of one
    slot fall on 32 banks."""
    slots = SLOTS["ADD_SLOTS"]
    written = np.zeros((3, 24, B), np.int64)
    owner = {}
    for b in range(-(-B // T)):
        for t in range(T):
            i = b * T + t
            if i >= B:
                continue
            j = q_lane(i, B, Bq, rep)
            assert 0 <= j < Bq and j == (i // rep) % Bq or Bq == B
            for s in range(slots):
                for k in range(12):
                    addr = (s * 12 + k) * T + t
                    assert 0 <= addr < slots * 12 * T
                    assert owner.setdefault((b, addr), t) == t
            for c in range(3):
                for k in range(24):
                    written[c, k, i] += 1
        for w in range(0, T, 32):
            for s in range(slots):
                for k in range(12):
                    banks = {((s * 12 + k) * T + t) % 32 for t in range(w, min(w + 32, T))}
                    assert len(banks) == min(32, T - w)
    assert (written == 1).all()


def test_q_lane_32_bit_matches_64_bit():
    rng = np.random.default_rng(5)
    for _ in range(2000):
        B = int(rng.integers(1, 1 << 31))
        Bq = int(rng.integers(1, B + 1))
        rep = int(rng.integers(1, B + 1))
        i = int(rng.integers(0, B))
        assert q_lane(i, B, Bq, rep) == (i // rep) % Bq
    assert q_lane((1 << 31) - 2, (1 << 31) - 1, 3, 1) == ((1 << 31) - 2) % 3
    assert q_lane((1 << 33) + 5, 1 << 34, 7, 2) == ((1 << 33) + 5) // 2 % 7


# --- the header compiled with g++ ------------------------------------------------

_PRELUDE = r"""
#include <cstdint>
#include <cstdio>
#define __device__
#define __host__
#define __forceinline__ inline
struct uint4 { uint32_t x, y, z, w; };
static inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return {x, y, z, w}; }
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  s &= 31u;
  return s ? (hi << s) | (lo >> (32u - s)) : hi;
}
"""

# PTX's one carry flag (CC.CF: the carry of an add, the borrow of a subtract)
_CARRY = r"""
static uint32_t CF = 0;
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) { uint64_t s = (uint64_t)a + b; CF = (uint32_t)(s >> 32); return (uint32_t)s; }
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) { uint64_t s = (uint64_t)a + b + CF; CF = (uint32_t)(s >> 32); return (uint32_t)s; }
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) { return a + b + CF; }
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) { uint64_t d = (uint64_t)a - b; CF = (uint32_t)(d >> 63); return (uint32_t)d; }
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) { uint64_t d = (uint64_t)a - b - CF; CF = (uint32_t)(d >> 63); return (uint32_t)d; }
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) { return a - b - CF; }
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return add_cc(a * b, c); }
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return addc_cc(a * b, c); }
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) { return add_cc(__umulhi(a, b), c); }
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) { return addc_cc(__umulhi(a, b), c); }
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) { return addc(__umulhi(a, b), c); }
"""

_MAIN = r"""
#include "g1_lazy.cuh"
using fqc::fe;
static const fql::Step kProg[] = {G1_ADD_PROGRAM, G1_DBL_PROGRAM};
static const fql::Step kAddOnly[] = {G1_ADD_PROGRAM};
static const int kAdd = sizeof(kAddOnly) / sizeof(fql::Step);
static const int kAll = sizeof(kProg) / sizeof(fql::Step);
struct Slots {
  fe* s;
  void load(fe& r, int k) const { for (int w = 0; w < 12; ++w) r[w] = s[k][w]; }
  void store(int k, const fe& v) const { for (int w = 0; w < 12; ++w) s[k][w] = v[w]; }
};
struct Prog { fql::Step operator()(int s) const { return kProg[s]; } };
static bool get(fe& v) { return fread(v, 4, 12, stdin) == 12; }
static void put(const fe& v) { fwrite(v, 4, 12, stdout); }
int main() {
  // per record: a, b -> mul, sqr(a), add, sub, reduce(a); then the add's
  // program on slots 0-5 (a record of 6 elements) -> its 8 slots, and the
  // doubling's on slots 0-2 -> its 5
  int mode;
  while (fread(&mode, 4, 1, stdin) == 1) {
    if (mode == 0) {
      fe a, b, r;
      get(a); get(b);
      fql::mul(r, a, b); put(r);
      fql::sqr(r, a); put(r);
      fql::add(r, a, b); put(r);
      fql::sub(r, a, b); put(r);
      fql::reduce(r, a); put(r);
    } else {
      fe s[8];
      for (int k = 0; k < 6; ++k) get(s[k]);
      fe p[3] = {};
      for (int k = 0; k < 3; ++k) for (int w = 0; w < 12; ++w) p[k][w] = s[k][w];
      Slots S{s};
      fql::run(S, Prog{}, 0, kAdd);
      for (int k = 0; k < 8; ++k) put(s[k]);
      for (int k = 0; k < 3; ++k) for (int w = 0; w < 12; ++w) s[k][w] = p[k][w];
      fql::run(S, Prog{}, kAdd, kAll);
      for (int k = 0; k < 5; ++k) put(s[k]);
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """g1_lazy.cuh and fq_chain.cuh built with g++, the carry primitives
    (between fq_chain.cuh's carry-primitives markers) replaced by C."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the host model of g1_lazy.cuh"
    d = tmp_path_factory.mktemp("g1_lazy")
    chain = read("fq_chain.cuh")
    a, b = chain.index("// carry-primitives-begin"), chain.index("// carry-primitives-end")
    chain = chain[:a] + _CARRY + chain[b:]
    chain = chain.replace("#include <cuda_runtime.h>", "")
    (d / "fq_chain.cuh").write_text(_PRELUDE + chain)
    (d / "g1_lazy.cuh").write_text(read("g1_lazy.cuh"))
    (d / "main.cpp").write_text(_MAIN)
    exe = d / "g1_lazy_host"
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(exe), str(d / "main.cpp")],
                   check=True, capture_output=True, text=True, cwd=d)

    def call(records):
        """[(mode, [ints])] -> the harness's output ints, 12 words each."""
        data = b"".join(np.int32(m).tobytes() + b"".join(
            np.array([(v >> (32 * k)) & M32 for k in range(12)], np.uint32).tobytes()
            for v in vals) for m, vals in records)
        out = subprocess.run([str(exe)], input=data, capture_output=True, check=True).stdout
        w = np.frombuffer(out, np.uint32).reshape(-1, 12)
        return [sum(int(x) << (32 * k) for k, x in enumerate(row)) for row in w]

    return call


def test_header_field_ops_match_model(harness):
    rng = np.random.default_rng(6)
    edge = [0, 1, 2, q - 1, q, q + 1, 2 * q - 2, 2 * q - 1, ONE, (1 << 380) + 12345]
    vals = edge + [int.from_bytes(rng.bytes(48), "little") % (2 * q) for _ in range(200)]
    pairs = [(a, b) for a in edge for b in edge] + list(zip(vals[10::2], vals[11::2]))
    out = harness([(0, [a, b]) for a, b in pairs])
    for n, (a, b) in enumerate(pairs):
        want = [mont(a, b), mont_sqr(a), add2(a, b), sub2(a, b), reduce(a)]
        assert out[5 * n: 5 * n + 5] == want, (a, b)


def test_header_programs_match_model(harness):
    """Both programs, slot by slot, on planted and seeded lanes (finite:
    the programs run only there), each input below q."""
    P, Q = planted_pairs(7)
    lanes = [(p, x) for p, x in zip(cols(P), cols(Q)) if p[2] and x[2]]
    ext = extreme_lanes(8, 24)
    lanes += list(zip(ext[:12], ext[12:]))
    out = harness([(1, list(p) + list(x)) for p, x in lanes])
    for n, (p, x) in enumerate(lanes):
        s = list(p) + list(x) + [None, None]
        run(s, ADD_PROG)
        d = list(p) + [None, None]
        run(d, DBL_PROG)
        assert out[13 * n: 13 * n + 8] == s
        assert out[13 * n + 8: 13 * n + 13] == d


# --- the sources' constants ------------------------------------------------------


def test_source_constants():
    chain, ops = read("fq_chain.cuh"), read("g1_ops.cu")
    words = lambda name, src: [int(w, 16) for w in re.findall(  # noqa: E731
        r"0x([0-9a-f]{8})u", src[src.index(name):src.index("}", src.index(name))])]
    assert sum(w << (32 * k) for k, w in enumerate(words("qw(int k)", chain))) == q
    assert sum(w << (32 * k) for k, w in enumerate(words("qone(int k)", chain))) == ONE
    assert sum(w << (32 * k) for k, w in enumerate(words("q2w(int k)", LAZY))) == 2 * q
    assert int(re.search(r"N0 = (0x[0-9a-f]+)u", chain).group(1), 16) == N0
    # every program reads a slot only after it holds a value, inside its slots
    for prog, first, slots in ((ADD_PROG, 6, SLOTS["ADD_SLOTS"]), (DBL_PROG, 3, SLOTS["DBL_SLOTS"])):
        live = set(range(first))
        for op, d, a, b in prog:
            assert a in live and (op == "SQR" or b in live) and d < slots
            live.add(d)
    assert sum(op in ("MUL", "SQR") for op, *_ in ADD_PROG) == 16
    assert sum(op in ("MUL", "SQR") for op, *_ in DBL_PROG) == 7
    assert [op for op, *_ in ADD_PROG].count("SQR") == 4
    assert [op for op, *_ in DBL_PROG].count("SQR") == 5
    # a block's slots fit the 48 KB a launch takes without opting in, and the
    # SM's shared memory at the launch bounds' blocks
    T = constant(ops, "int T")
    assert T % 32 == 0
    for slots, blocks in ((SLOTS["ADD_SLOTS"], constant(ops, "ADD_BLOCKS")),
                          (SLOTS["DBL_SLOTS"], constant(ops, "DBL_BLOCKS"))):
        assert slots * 12 * T * 4 <= 48 * 1024
        assert blocks * (slots * 12 * T * 4 + 1024) <= 228 * 1024
