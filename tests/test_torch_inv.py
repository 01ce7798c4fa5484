"""K2's schedule and its single inversion, modelled in Python at small tiles.

`backend/csrc/field_inv.cu` has no interpret mode, so its index schedule
and its extended gcd are written out here step by step, the way the kernels
run them, and held against `pow(x, -1, p)` (exact):

  * `inv_mont`: the variable-time safegcd on signed 30-bit limbs, with
    32-bit word arithmetic emulated (wrapping uint32 divsteps, int64
    accumulators checked for overflow), the batch count asserted against
    the source's MAX_BATCHES, and the final product with R^3 mod p;
  * the batch schedule, as the wrapper `kernels.batch_inv` runs it: up to
    EACH elements one inversion each (one launch); above, tiles where
    thread t of a block of T owns elements base + j T + t (each element
    visited once a phase), the shared-memory product tree in heap order
    and its walk down, and the up / totals / down launches; at T = 4
    threads, K = 2 elements a thread (tiles of 8) and EACH = 3, and with
    the card's own parameters for the launch pattern.

The constants of the source (tile shape, the moduli in 30-bit limbs,
p^-1 mod 2^30, R and R^3 mod p, the batch bounds) are read from it and
checked against values computed here.  One case also runs the JAX
package's `fr_batch_inv` on the same input.
"""

import os
import re

import numpy as np
import pytest

import jax.numpy as jnp

from tokamak_zk_evm_tpu.ops import field as JF
from tokamak_zk_evm_tpu_torch.backend import kernels as K
from tokamak_zk_evm_tpu_torch.fields import FQ, FR

SRC = os.path.join(os.path.dirname(K.__file__), "csrc", "field_inv.cu")
M32 = (1 << 32) - 1
M30 = (1 << 30) - 1


class Field:
    """A field as the kernel sees it: N 32-bit words, S signed 30-bit limbs,
    Montgomery form with R = 2^(32 N)."""

    def __init__(self, spec, N, S, tag):
        self.spec, self.p, self.N, self.S, self.tag = spec, spec.modulus, N, S, tag
        self.R = 1 << (32 * N)
        self.one = self.R % self.p
        self.r3 = pow(self.R, 3, self.p)
        self.rinv = pow(self.R, -1, self.p)
        d = self.p.bit_length()
        self.max_batches = -(-((49 * d + 57) // 17) // 30)  # Bernstein-Yang divstep bound

    def mul(self, a, b):
        return a * b * self.rinv % self.p

    def mont(self, v):
        return v * self.R % self.p

    def plain(self, x):
        return x * self.rinv % self.p


FIELDS = {"fr": Field(FR, 8, 9, "Fr"), "fq": Field(FQ, 12, 13, "Fq")}


# ---------------------------------------------------------------------------
# the single inversion, word for word
# ---------------------------------------------------------------------------


def i32(x):
    x &= M32
    return x - (1 << 32) if x >> 31 else x


def i64(x):
    assert -(1 << 63) <= x < (1 << 63), "int64 accumulator overflow"
    return x


def ctz(x):
    return (x & -x).bit_length() - 1


def divsteps_30(eta, f, g):
    """The kernel's `divsteps_30` on uint32 words: (eta, [u, v, q, r])."""
    u, v, q, r = 1, 0, 0, 1
    i = 30
    while True:
        zeros = ctz((g | (M32 << i)) & M32)
        g >>= zeros
        u, v = (u << zeros) & M32, (v << zeros) & M32
        eta -= zeros
        i -= zeros
        if i == 0:
            break
        if eta < 0:
            eta = -eta
            f, g = g, -f & M32
            u, q = q, -u & M32
            v, r = r, -v & M32
        limit = min(eta + 1, i)
        m = (M32 >> (32 - limit)) & 63
        w = (g * f * ((f * f - 2) & M32)) & M32 & m
        g = (g + f * w) & M32
        q = (q + u * w) & M32
        r = (r + v * w) & M32
    return eta, [i32(u), i32(v), i32(q), i32(r)]


def update_de(F, pinv, p30, d, e, t):
    u, v, q, r = t
    sd, se = d[-1] >> 31, e[-1] >> 31
    md, me = (u & sd) + (v & se), (q & sd) + (r & se)
    cd, ce = i64(u * d[0] + v * e[0]), i64(q * d[0] + r * e[0])
    md -= (pinv * (cd & M32) + md) & M30
    me -= (pinv * (ce & M32) + me) & M30
    assert i32(md) == md and i32(me) == me
    cd, ce = i64(cd + p30[0] * md), i64(ce + p30[0] * me)
    assert cd & M30 == 0 and ce & M30 == 0
    cd >>= 30
    ce >>= 30
    for i in range(1, F.S):
        cd = i64(cd + u * d[i] + v * e[i] + p30[i] * md)
        ce = i64(ce + q * d[i] + r * e[i] + p30[i] * me)
        d[i - 1], e[i - 1] = cd & M30, ce & M30
        cd >>= 30
        ce >>= 30
    assert i32(cd) == cd and i32(ce) == ce
    d[-1], e[-1] = cd, ce


def update_fg(F, f, g, t):
    u, v, q, r = t
    cf, cg = i64(u * f[0] + v * g[0]), i64(q * f[0] + r * g[0])
    assert cf & M30 == 0 and cg & M30 == 0
    cf >>= 30
    cg >>= 30
    for i in range(1, F.S):
        cf = i64(cf + u * f[i] + v * g[i])
        cg = i64(cg + q * f[i] + r * g[i])
        f[i - 1], g[i - 1] = cf & M30, cg & M30
        cf >>= 30
        cg >>= 30
    assert i32(cf) == cf and i32(cg) == cg
    f[-1], g[-1] = cf, cg


def add_p(p30, d, mask):
    c = 0
    for i in range(len(d) - 1):
        c += d[i] + (p30[i] & mask)
        d[i] = c & M30
        c >>= 30
    d[-1] += (p30[-1] & mask) + c


def to30(F, w):
    out = []
    for i in range(F.S):
        k, s = (30 * i) >> 5, (30 * i) & 31
        t = w[k] | (w[k + 1] << 32 if k + 1 < F.N else 0)
        out.append((t >> s) & M30)
    return out


def from30(F, limbs):
    out = []
    for k in range(F.N):
        i, s = (32 * k) // 30, (32 * k) % 30
        assert s <= 28
        t = limbs[i] | (limbs[i + 1] << 30 if i + 1 < F.S else 0)
        out.append((t >> s) & M32)
    return out


def words(F, v):
    return [(v >> (32 * k)) & M32 for k in range(F.N)]


def value(ws, bits):
    return sum(x << (bits * k) for k, x in enumerate(ws))


def inv_mont(F, x, consts, batches=None):
    """The kernel's `inv_mont` on x = aR: -> a^-1 R (0 -> 0)."""
    p30, pinv, max_batches = consts["p30"], consts["pinv30"], consts["max_batches"]
    d, e, f = [0] * F.S, [1] + [0] * (F.S - 1), list(p30)
    g = to30(F, words(F, x))
    eta = -1
    for b in range(max_batches):
        eta, t = divsteps_30(eta, f[0], g[0])
        update_de(F, pinv, p30, d, e, t)
        update_fg(F, f, g, t)
        assert -2 * F.p < value(d, 30) < F.p
        if not any(g):
            break
    else:
        raise AssertionError("gcd did not finish within MAX_BATCHES")
    if batches is not None:
        batches.append(b + 1)
    assert value(f, 30) in ((1, -1) if x else (F.p,))
    add_p(p30, d, d[-1] >> 31)  # normalize: d in (-2p, p) -> d f mod p
    neg, c = f[-1] >> 31, 0
    for i in range(F.S - 1):
        c += (d[i] ^ neg) - neg
        d[i] = c & M30
        c >>= 30
    d[-1] = ((d[-1] ^ neg) - neg) + c
    add_p(p30, d, d[-1] >> 31)
    y = value(from30(F, d), 32)
    assert 0 <= y < F.p
    return F.mul(y, value([consts["r3"][k] for k in range(F.N)], 32))


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


class Run:
    """One batch inverse through the kernels' schedule: batches up to `each`
    elements one inversion each (`inv_kernel`); wider ones over tiles of
    `threads` x `per_thread` (`binv_up`, `inv_kernel` on the tile totals,
    `binv_down`).  Each phase asserts that it touched every element once."""

    def __init__(self, F, consts, threads, per_thread, each):
        self.F, self.consts = F, consts
        self.threads, self.per_thread, self.each = threads, per_thread, each
        self.tile = threads * per_thread
        self.launches = []

    def thread_up(self, a, pre, base, n, t, seen):
        F, s = self.F, self.F.one
        for j in range(self.per_thread):
            i = j * self.threads + t
            if i >= n:
                break
            seen[base + i] += 1
            pre[base + i] = s
            if a[base + i]:
                s = F.mul(s, a[base + i])
        return s

    def thread_down(self, a, out, base, n, t, inv, seen):
        for j in range(self.per_thread - 1, -1, -1):
            i = j * self.threads + t
            if i >= n:
                continue
            seen[base + i] += 1
            x = a[base + i]
            if x == 0:
                out[base + i] = 0
            else:
                out[base + i] = self.F.mul(out[base + i], inv)
                inv = self.F.mul(inv, x)

    def tree_up(self, leaves):
        """Heap order: leaves at T + t, node h = node 2h * node 2h+1, one
        level (one __syncthreads) at a time; the total at node 1."""
        T = len(leaves)
        tr = [None] * T + list(leaves)
        s = T >> 1
        while s >= 1:
            for t in range(s):
                h = s + t
                tr[h] = self.F.mul(tr[2 * h], tr[2 * h + 1])
            s >>= 1
        return tr

    def tree_down(self, tr, T):
        s = 1
        while s < T:
            for t in range(s):
                h = s + t
                inv, left, right = tr[h], tr[2 * h], tr[2 * h + 1]
                tr[2 * h], tr[2 * h + 1] = self.F.mul(inv, right), self.F.mul(inv, left)
            s <<= 1

    def inv_each(self, a):
        self.launches.append(("each", len(a)))
        return [inv_mont(self.F, x, self.consts) if x else 0 for x in a]

    def tiles(self, B):
        for b in range(-(-B // self.tile)):
            yield b, b * self.tile, min(self.tile, B - b * self.tile)

    def binv_up(self, a, pre, tot):
        B, T = len(a), self.threads
        self.launches.append(("up", len(tot)))
        seen = [0] * B
        for b, base, n in self.tiles(B):
            tr = self.tree_up([self.thread_up(a, pre, base, n, t, seen) for t in range(T)])
            tot[b] = tr[1]
        assert seen == [1] * B

    def binv_down(self, a, out, tinv):
        B, T = len(a), self.threads
        self.launches.append(("down", len(tinv)))
        seen = [0] * B
        for b, base, n in self.tiles(B):
            leaves = []
            for t in range(T):  # each thread's total from its last prefix
                s = self.F.one
                if t < n:
                    last = t + (n - 1 - t) // T * T
                    s = out[base + last]
                    if a[base + last]:
                        s = self.F.mul(s, a[base + last])
                leaves.append(s)
            tr = self.tree_up(leaves)
            tr[1] = tinv[b]
            self.tree_down(tr, T)
            for t in range(T):
                self.thread_down(a, out, base, n, t, tr[T + t], seen)
        assert seen == [1] * B

    def batch_inv(self, a):
        """`kernels.batch_inv` on the card."""
        B = len(a)
        if B <= self.each:
            return self.inv_each(a)
        out = [None] * B
        tot = [None] * -(-B // self.tile)
        self.binv_up(a, out, tot)
        assert all(tot)  # products of nonzero elements, or one
        tinv = self.inv_each(tot)
        self.binv_down(a, out, tinv)
        return out


# ---------------------------------------------------------------------------
# the source's constants
# ---------------------------------------------------------------------------


def _source_consts():
    src = open(SRC).read()
    ints = lambda body: [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u?", body)]  # noqa: E731

    def fn(struct, name):
        body = re.search(rf"struct {struct} \{{.*?{name}\(int k\) \{{(.*?)\}}", src, re.S)
        return ints(body.group(1)) if body else None

    out = {"threads": int(re.search(r"constexpr int THREADS = (\d+);", src).group(1))}
    for tag, struct in (("fr", "FrF"), ("fq", "FqF")):
        head = re.search(rf"struct {struct} \{{\s*static constexpr int N = (\d+), S = (\d+), "
                         rf"MAX_BATCHES = (\d+);\s*static constexpr uint32_t PINV30 = "
                         rf"0x([0-9a-f]+)u;", src)
        p30 = fn(struct, "p30")
        # the value each constant stands for, with the word (or limb) order
        # undone: p30's entries are in the k order of its ternary chain
        out[tag] = {"N": int(head.group(1)), "S": int(head.group(2)),
                    "max_batches": int(head.group(3)), "pinv30": int(head.group(4), 16),
                    "p30": p30, "r3": fn(struct, "r3"), "one": fn(struct, "one")}
    return out


CONSTS = _source_consts()


def consts(field):
    c = dict(CONSTS[field])
    if not c["one"]:  # FqF::one reads fq_chain.cuh's qone
        F = FIELDS[field]
        c["one"] = words(F, F.one)
    return c


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_source_constants(field):
    F, c = FIELDS[field], consts(field)
    assert (c["N"], c["S"]) == (F.N, F.S)
    assert c["max_batches"] == F.max_batches
    assert c["p30"] == to30(F, words(F, F.p))
    assert value(c["p30"], 30) == F.p
    assert c["pinv30"] == pow(F.p, -1, 1 << 30)
    assert value(c["r3"], 32) == F.r3
    assert value(c["one"], 32) == F.one


def test_source_tile_shape_matches_wrapper():
    assert CONSTS["threads"] == K.BINV_THREADS


# ---------------------------------------------------------------------------
# the single inversion against pow
# ---------------------------------------------------------------------------


def special_values(F):
    p = F.p
    return [1, p - 1, 2, 1 << 64, 1 << (p.bit_length() - 1), F.R % p, F.rinv, (p - 1) // 2]


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_gcd_inverse_special_values(field):
    F, c = FIELDS[field], consts(field)
    for v in special_values(F):
        assert inv_mont(F, F.mont(v), c) == F.mont(pow(v, -1, F.p)), hex(v)
    assert inv_mont(F, 0, c) == 0


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_gcd_inverse_random_within_bound(field):
    F, c = FIELDS[field], consts(field)
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(300):
        v = int.from_bytes(rng.bytes(48), "little") % F.p or 1
        assert inv_mont(F, F.mont(v), c, batches) == F.mont(pow(v, -1, F.p))
    assert max(batches) <= F.max_batches
    # the variable-time loop ends well inside the bound on random inputs
    assert np.mean(batches) < 0.8 * F.max_batches


# ---------------------------------------------------------------------------
# the schedule against pow: T = 4 threads, K = 2 elements a thread (tiles of
# 8), batches up to EACH = 3 one inversion each
# ---------------------------------------------------------------------------

T_MODEL, K_MODEL, EACH = 4, 2, 3
TILE = T_MODEL * K_MODEL


def model(field):
    return Run(FIELDS[field], consts(field), T_MODEL, K_MODEL, EACH)


def batch(F, B, seed, zeros=()):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % F.p for _ in range(B)]
    for k, v in enumerate(special_values(F)[: B // 2]):
        vals[(3 * k + 1) % B] = v
    for z in zeros:
        if 0 <= z < B:
            vals[z] = 0
    return [F.mont(v) for v in vals]


def check(field, a):
    F = FIELDS[field]
    run = model(field)
    assert run.batch_inv(a) == [F.mont(pow(F.plain(x), -1, F.p)) if x else 0 for x in a]
    return run


# B = 1; the one-launch path's width +-1; the tile +-1; a tile of threads'
# worth of tiles +-1 and TILE^2 +-1 (wider tile-total batches, more than
# EACH of them); zeros at every tile edge, at the last thread of a tile's
# first row and one past it.
SIZES = [1, 2, EACH, EACH + 1, TILE - 1, TILE, TILE + 1, 2 * TILE + 3, TILE * T_MODEL - 1,
         TILE * T_MODEL, TILE * T_MODEL + 1, TILE * TILE - 1, TILE * TILE, TILE * TILE + 1]


@pytest.mark.parametrize("B", SIZES)
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_schedule_matches_pow(field, B):
    edges = [z for b in range(0, B + TILE, TILE) for z in (b - 1, b, b + T_MODEL - 1, b + T_MODEL)]
    run = check(field, batch(FIELDS[field], B, B, zeros=edges if B > EACH else ()))
    nt = -(-B // TILE)
    want = [("each", B)] if B <= EACH else [("up", nt), ("each", nt), ("down", nt)]
    assert run.launches == want


@pytest.mark.parametrize("B", [1, EACH + 1, TILE, TILE + 1, TILE * T_MODEL + 1])
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_schedule_all_zero(field, B):
    assert model(field).batch_inv([0] * B) == [0] * B


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_schedule_one_live_element_per_tile(field):
    """Whole tiles of zeros but one element: tile totals of one, thread totals of one."""
    F = FIELDS[field]
    B = 5 * TILE + 2
    a = [0] * B
    for b in range(0, B, TILE):
        a[min(B - 1, b + 5)] = F.mont(b + 7)
    check(field, a)


def test_schedule_matches_jax_fr_batch_inv():
    """The modelled kernels and the JAX package's `fr_batch_inv`, same input."""
    F = FIELDS["fr"]
    B = 2 * TILE + 3
    a = batch(F, B, 5, zeros=(0, TILE - 1, TILE, B - 1))
    got = model("fr").batch_inv(a)
    limbs = np.array([FR.to_limbs(x) for x in a], dtype=np.uint32).T
    want = np.asarray(JF.fr_batch_inv(jnp.asarray(limbs))).astype(np.uint32)
    assert [FR.from_limbs(want[:, i].tolist()) for i in range(B)] == got


@pytest.mark.parametrize("B", [1, 1 << 16, (1 << 17) - 1, 1 << 17, 3 << 17, 1 << 20, 1 << 22,
                               1 << 26])
def test_per_thread_rule(B):
    """Powers of two from 1 to the cap; wider batches never take fewer."""
    k = K.binv_per_thread(1, B)
    assert k & (k - 1) == 0 and 1 <= k <= K.BINV_MAX_PER_THREAD
    assert K.binv_per_thread(1, 2 * B) >= k
    assert k == K.BINV_MAX_PER_THREAD or B < (k << 17)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_card_schedule_launches(field):
    """The card's own parameters: BINV_EACH elements is one launch, one more
    three; the tiles cover the batch with the wrapper's per-thread count."""
    F = FIELDS[field]
    f = ("fr", "fq").index(field)
    each = K.BINV_EACH[f]
    for B in (each, each + 1):
        per = K.binv_per_thread(f, B)
        run = Run(F, consts(field), K.BINV_THREADS, per, each)
        run.inv_each = lambda a, run=run: (run.launches.append(("each", len(a))), a)[1]
        a = [F.one] * B
        assert run.batch_inv(a) == a
        nt = -(-B // (K.BINV_THREADS * per))
        assert run.launches == ([("each", B)] if B <= each else
                                [("up", nt), ("each", nt), ("down", nt)])
