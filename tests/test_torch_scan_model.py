"""B6's scan kernel (`backend/csrc/fr_scan.cu`), modelled on the CPU.

The kernel has no interpret mode, so its order of work is written out here
on Python ints (Montgomery form, exact) and held against a plain scan and
the JAX package's `fr_prefix_prod` / `fr_suffix_prod`:

  * blocks take tiles from a counter in launch order, a few resident at a
    time, and advance one step at a time in a random order, so tiles finish
    in a random order and wait on each other's status records;
  * inside a tile: the staged positions, each thread's serial scan of its K
    positions, the shuffle scan of the thread totals within each warp and of
    the warp totals, the tile's aggregate, the product of the aggregates of
    the tiles before it in its group (a warp product over the lanes that
    hold one), the group's aggregate and prefix published by its last tile,
    and the windowed look-back over the groups before (flags NONE,
    AGGREGATE, PREFIX; wait until each group up to the nearest prefix has an
    aggregate; move the window back while none has a prefix);
  * at the source's constants, at widths 1, K - 1, a tile - 1, a tile, a
    tile + 1 and 33 tiles + 5, with zeros at those edges or none, both
    directions, against the JAX package; at small warps, groups and windows
    (so that windows move back) against a plain scan;
  * fr_chain.cuh's two products (`mul`, and `mul_wide`, the scan's), built
    with g++ (the PTX carry primitives replaced by C over one carry flag, as
    tests/test_torch_g1_model.py does for fq_chain.cuh) and held to Python's
    Montgomery product on edge and random operands;
  * the source's constants, and the wrapper's scratch size.

Tolerance: exact.
"""

import os
import random
import re
import shutil
import subprocess

import numpy as np
import pytest

import jax.numpy as jnp

from test_torch_g1_model import _CARRY, _PRELUDE
from tokamak_zk_evm_tpu.ops import field as JF
from tokamak_zk_evm_tpu_torch.backend import kernels as K
from tokamak_zk_evm_tpu_torch.fields import R_MOD

CSRC = os.path.join(os.path.dirname(K.__file__), "csrc")


def read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


SRC = read("fr_scan.cu")


def constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


THREADS, PER, GROUP, WINDOW = (constant(n) for n in ("THREADS", "K", "GROUP", "WINDOW"))
TILE = THREADS * PER
FLAGS = re.search(r"NONE = (\d+), AGGREGATE = (\d+), PREFIX = (\d+);", SRC).groups()
NONE, AGGREGATE, PREFIX = (int(v) for v in FLAGS)

r = R_MOD
RINV = pow(1 << 256, -1, r)
ONE = (1 << 256) % r


def mont(a, b):
    return a * b * RINV % r


def warp_product(x, last):
    """The kernel's `warp_product`: xor butterflies over levels 1, 2, 4, ...
    up to `last`, then lane 0's value (the lanes above `last` hold one)."""
    d = 1
    while d <= last:
        x = [mont(x[i], x[i ^ d]) for i in range(len(x))]
        d <<= 1
    return x[0]


class Launch:
    """One call's status records and counter, as the wrapper zeroes them."""

    def __init__(self, vals, rev, threads, per, warp, group, window):
        self.vals, self.rev, self.B = vals, rev, len(vals)
        self.threads, self.per, self.warp, self.group, self.window = (
            threads, per, warp, group, window)
        self.tile = threads * per
        self.ntiles = -(-self.B // self.tile)
        ngroups = -(-self.ntiles // group)
        self.counter = 0
        self.tflag, self.tagg = [NONE] * self.ntiles, [None] * self.ntiles
        self.gflag, self.gagg, self.gincl = [NONE] * ngroups, [None] * ngroups, [None] * ngroups
        self.out = [None] * self.B
        self.moves = self.waits = 0

    def elem(self, s):
        return self.B - 1 - s if self.rev else s


def look_back(L, g):
    """Warp 0's look-back over the groups before g (a generator: it yields
    while a group it needs has published nothing)."""
    pre, top = ONE, g - 1
    while True:
        while True:
            f = [L.gflag[top - i] if top - i >= 0 else PREFIX for i in range(L.window)]
            found = [i for i in range(L.window) if f[i] == PREFIX]
            last = found[0] if found else L.window - 1
            if all(f[i] != NONE for i in range(last + 1)):
                break
            L.waits += 1
            yield
        x = [ONE if i > last or top - i < 0 else
             (L.gincl if f[i] == PREFIX else L.gagg)[top - i] for i in range(L.window)]
        x += [ONE] * (L.warp - L.window)
        pre = mont(pre, warp_product(x, last))
        if found:
            return pre
        L.moves += 1
        top -= L.window


def block(L):
    """One block of the kernel, as a generator that yields where it may wait."""
    j = L.counter
    L.counter += 1
    yield
    T, P, W = L.threads, L.per, L.warp
    base = j * L.tile
    n = min(L.tile, L.B - base)
    st = [L.vals[L.elem(base + s)] for s in range(n)]
    # each thread's positions, scanned in place; the thread totals
    totals = []
    for t in range(T):
        pos = range(t * P, min(n, t * P + P))
        acc = ONE
        for k, s in enumerate(pos):
            acc = st[s] if k == 0 else mont(acc, st[s])
            st[s] = acc
        totals.append(acc)
    # the shuffle scan within each warp: inclusive, then shifted by a lane
    ex, wtot = [], []
    for w in range(T // W):
        v = totals[w * W:(w + 1) * W]
        d = 1
        while d < W:
            v = [mont(v[i - d], v[i]) if i >= d else v[i] for i in range(W)]
            d <<= 1
        ex += [ONE] + v[:-1]
        wtot.append(v[-1])
    yield
    # warp 0: the warp totals' scan, the tile's aggregate
    nw = T // W
    v = wtot + [ONE] * (W - nw)
    d = 1
    while d < nw:
        v = [mont(v[i - d], v[i]) if i >= d else v[i] for i in range(W)]
        d <<= 1
    tot, wex = v[nw - 1], [ONE] + v[:nw - 1]
    g, q = divmod(j, L.group)
    closes = q == L.group - 1 or j == L.ntiles - 1
    if not closes:
        L.tagg[j], L.tflag[j] = tot, AGGREGATE
    yield
    while any(L.tflag[g * L.group + i] == NONE for i in range(q)):
        L.waits += 1
        yield
    e = warp_product([L.tagg[g * L.group + i] if i < q else ONE for i in range(W)], q - 1)
    if closes:
        tot = mont(e, tot)
        if g == 0:
            x = ONE
            L.gincl[g], L.gflag[g] = tot, PREFIX
        else:
            L.gagg[g], L.gflag[g] = tot, AGGREGATE
            yield
            x = yield from look_back(L, g)
            L.gincl[g], L.gflag[g] = mont(x, tot), PREFIX
    elif g == 0:
        x = ONE
    else:
        x = yield from look_back(L, g)
    e = mont(x, e)
    wp = [mont(e, wex[w]) for w in range(nw)]
    yield
    # every position times its thread's exclusive prefix, then stored
    for t in range(T):
        acc = mont(wp[t // W], ex[t])
        for s in range(t * P, min(n, t * P + P)):
            st[s] = mont(acc, st[s])
    for s in range(n):
        L.out[L.elem(base + s)] = st[s]


def run_model(vals, rev, seed, resident, threads=THREADS, per=PER, warp=32, group=GROUP,
              window=WINDOW):
    """The kernel's output for `vals` (ints < r), blocks resident `resident`
    at a time and stepped in an order drawn from `seed`."""
    L = Launch(vals, rev, threads, per, warp, group, window)
    rng = random.Random(seed)
    live = []
    while L.counter < L.ntiles or live:
        while len(live) < resident and L.counter < L.ntiles:
            b = block(L)
            next(b)  # takes its tile: blocks start in launch order
            live.append(b)
        b = rng.choice(live)
        try:
            next(b)
        except StopIteration:
            live.remove(b)
    assert None not in L.out
    return L


def plain_scan(vals, rev):
    out, acc = [None] * len(vals), None
    for i in (range(len(vals) - 1, -1, -1) if rev else range(len(vals))):
        acc = vals[i] if acc is None else mont(acc, vals[i])
        out[i] = acc
    return out


def limbs_of(vals):
    a = np.zeros((16, len(vals)), np.uint32)
    for i, v in enumerate(vals):
        for k in range(16):
            a[k, i] = (v >> (16 * k)) & 0xFFFF
    return a


def ints_of(a):
    a = np.asarray(a).astype(np.uint64)
    return [sum(int(a[k, i]) << (16 * k) for k in range(16)) for i in range(a.shape[1])]


def random_vals(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(1, r) for _ in range(n)]


WIDTHS = {"1": 1, "K-1": PER - 1, "tile-1": TILE - 1, "tile": TILE, "tile+1": TILE + 1,
          "33 tiles+5": 33 * TILE + 5}


@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_model_matches_jax(width, rev, zeros):
    """The model at the source's constants == the JAX package's scan, with
    zeros at a thread's, a warp's, a tile's and a group's edges (in scan
    order) or none."""
    n = WIDTHS[width]
    vals = random_vals(n, n + 11)
    if zeros:
        for s in (PER - 1, PER, 32 * PER - 1, 32 * PER, TILE - 1, TILE, 32 * TILE, 33 * TILE):
            if s < n:
                vals[n - 1 - s if rev else s] = 0
    L = run_model(vals, rev, seed=n, resident=6)
    fn = JF.fr_suffix_prod if rev else JF.fr_prefix_prod
    want = ints_of(np.asarray(fn(jnp.asarray(limbs_of(vals)))))
    assert L.out == want


@pytest.mark.parametrize("seed", range(6))
def test_model_random_orders(seed):
    """Small warps, groups and windows (4 lanes; 2 or 4 positions a thread),
    blocks resident 1 to 64 at a time and stepped in random orders: the
    output equals the plain scan, with zeros planted or none, both
    directions, and tiles wait on each other's records."""
    rng = random.Random(seed)
    waits = 0
    for case in range(8):
        threads, per = rng.choice([(4, 2), (8, 2), (8, 4)])
        n = rng.randrange(1, 60 * threads * per)
        vals = random_vals(n, 100 * seed + case)
        for _ in range(rng.randrange(3)):
            vals[rng.randrange(n)] = 0
        rev = bool(case % 2)
        L = run_model(vals, rev, seed=case, resident=rng.choice([1, 3, 24, 64]),
                      threads=threads, per=per, warp=4, group=4, window=4)
        assert L.out == plain_scan(vals, rev)
        waits += L.waits
    assert waits > 0


@pytest.mark.parametrize("rev", [False, True])
def test_model_window_moves_back(rev):
    """40 groups of 4 tiles, 96 blocks resident: look-backs find no prefix
    in their window of 4 groups and move it back, and the output is still
    the plain scan."""
    vals = random_vals(8 * 4 * 40 + 3, 1)
    vals[8 * 4 * 21] = 0
    L = run_model(vals, rev, seed=1, resident=96, threads=4, per=2, warp=4, group=4, window=4)
    assert L.moves > 0
    assert L.out == plain_scan(vals, rev)


def test_source_constants():
    """The wrapper's constants and scratch size follow the source's: the
    tile, a thread's positions, the group, and the words the C entry asks
    for (1 + 9 per tile + 17 per group)."""
    assert (TILE, PER, GROUP) == (K.SCAN_TILE, K.SCAN_K, K.SCAN_GROUP)
    assert THREADS % 32 == 0 and GROUP <= 32 and WINDOW <= 32
    assert "words < 1 + (1 + frc::N) * nt + (1 + 2 * frc::N) * ng" in SRC
    for B in (1, TILE, TILE + 1, 32 * TILE, 32 * TILE + 1, 1 << 20, (1 << 24) + 3):
        nt = -(-B // TILE)
        assert K.scan_status_words(B) == 1 + 9 * nt + 17 * -(-nt // GROUP)
    assert (NONE, AGGREGATE, PREFIX) == (0, 1, 2)  # zeroed scratch reads as NONE


_MAIN = r"""
#include "fr_chain.cuh"
int main() {
  // per record a, b -> mul(a, b), mul_wide(a, b)
  uint32_t a[8], b[8], o[8];
  while (fread(a, 4, 8, stdin) == 8 && fread(b, 4, 8, stdin) == 8) {
    frc::mul(o, a, b); fwrite(o, 4, 8, stdout);
    frc::mul_wide(o, a, b); fwrite(o, 4, 8, stdout);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def products(tmp_path_factory):
    """fr_chain.cuh built with g++: records of (a, b) -> (mul, mul_wide)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the host model of fr_chain.cuh"
    d = tmp_path_factory.mktemp("fr_chain")
    chain = read("fq_chain.cuh")
    a, b = chain.index("// carry-primitives-begin"), chain.index("// carry-primitives-end")
    chain = chain[:a] + _CARRY + chain[b:]
    (d / "fq_chain.cuh").write_text(_PRELUDE + chain.replace("#include <cuda_runtime.h>", ""))
    (d / "fr_chain.cuh").write_text(read("fr_chain.cuh"))
    (d / "main.cpp").write_text(_MAIN)
    exe = d / "fr_chain_host"
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(exe), str(d / "main.cpp")],
                   check=True, capture_output=True, text=True, cwd=d)

    def call(pairs):
        data = b"".join(x.to_bytes(32, "little") + y.to_bytes(32, "little") for x, y in pairs)
        out = subprocess.run([str(exe)], input=data, capture_output=True, check=True).stdout
        w = [int.from_bytes(out[32 * i:32 * i + 32], "little") for i in range(len(out) // 32)]
        return list(zip(w[0::2], w[1::2]))

    return call


def test_products_match_python(products):
    """Both products == a b R^-1 mod r, on edge operands (0, 1, r - 1, the
    Montgomery one, top words at r's) and seeded random ones, some with
    their high words near r's (the bound `mul_wide` relies on)."""
    rng = random.Random(7)
    edge = [0, 1, 2, r - 1, r - 2, ONE, r - ONE, (1 << 255) % r, r >> 1, (r >> 32) << 32,
            r - (1 << 224)]
    pairs = [(x, y) for x in edge for y in edge]
    pairs += [(rng.randrange(r), rng.randrange(r)) for _ in range(3000)]
    pairs += [(r - 1 - rng.randrange(1 << 200), r - 1 - rng.randrange(1 << 64))
              for _ in range(1000)]
    for (x, y), (narrow, wide) in zip(pairs, products(pairs)):
        assert narrow == wide == mont(x, y), (hex(x), hex(y))
