"""Kernel wrappers: the op surface of the JAX package's `backend/api.py`.

Every op takes limb-major int32 tensors in the interchange layout
(`[L, B]`, little-endian 16-bit limbs, Montgomery form; the bit pattern of
the JAX package's uint32 arrays); K4's MSM stages take points packed
point-major (`pack_points`), which `g1_msm_start` makes from that layout.
A wrapper dispatches on the device of its tensor argument:

  * a CPU tensor goes to the op's plain PyTorch version, defined beside it;
  * a CUDA tensor launches the hand-written kernel (`csrc/*.cu`, built and
    bound by `build.py`) and adds one to that kernel's launch counter;
  * any other device raises.  Nothing falls back.

The kernels (see each source's header for the TPU kernel it replaces, what
bounds it on the card, and what its design does about that; K1 and K5 run
on `csrc/field.cuh`'s arithmetic, K2, B6 and K3 on `fr_chain.cuh`'s, K2, K4
and B13's to-affine pass on `fq_chain.cuh`'s carry chains, and B13's add and
doubling on `g1_lazy.cuh`'s):

  K1 csrc/field_ew.cu   FR_EW / FQ_EW    add, sub, mul, neg
  K2 csrc/field_inv.cu  FIELD_INV        inversion, an extended gcd a thread
                        BATCH_INV        tiled batch inversion (one tile, or
                                         up / top / down)
  B6 csrc/fr_scan.cu    FR_SCAN          inclusive Fr product scan, prefix
                                         or suffix, one pass (a decoupled
                                         look-back across tiles)
  K3 csrc/ntt.cu        NTT              NTT along either grid axis, stages
                                         fused in shared memory, one or two
                                         passes, the scale folded in; past
                                         2^22 points a four-step split over
                                         two K3 calls and a K1 product
  K4 csrc/g1.cu         G1_FIXED_BASE    k_i * G from a 12-bit window table
     csrc/msm.cu        MSM_BUCKET_SUM   bounded-chunk bucket sums
                        MSM_WINDOW       sum_b b * B_b, one level of segments
  K5 csrc/g1_affine.cu  AFF_PRE          affine-add slope denominators
                        AFF_POST         affine add from the inverted ones
  B13 csrc/g1_ops.cu    G1_ADD           complete jacobian add
                        G1_DBL           jacobian doubling
                        G1_TO_AFFINE     x Z^-2, y Z^-3 and inf, after K2
                                         inverts Z
      csrc/crs_decode.cu CRS_DECODE      rkyv G1 entries (the file's bytes)
                                         to Montgomery limb columns; no TPU
                                         kernel (the host decoded them)

The fixed-base op's 12-bit table is built by the op itself (at 8 bits) and
`g1_to_affine`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import FQ, FR, Q_MOD, R_MOD
from ..utils import timing
from . import build
from . import limbs

FR_L = FR.n_limbs
FQ_L = FQ.n_limbs
_FR = limbs.FR_LIMBS
_FQ = limbs.FQ_LIMBS
_PK = "tokamak_zk_evm_tpu/backend/pallas_kernels.py"


class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times it has been launched."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = "tokamak_zk_evm_tpu_torch/backend/csrc/" + source
        self.replaces = replaces
        self.launches = 0


FR_EW = Kernel("fr_ew", "field_ew.cu", f"{_PK}:267")
FQ_EW = Kernel("fq_ew", "field_ew.cu", f"{_PK}:267")
FIELD_INV = Kernel("field_inv", "field_inv.cu", f"{_PK}:382")
BATCH_INV = Kernel("batch_inv", "field_inv.cu", f"{_PK}:448")
FR_SCAN = Kernel("fr_scan", "fr_scan.cu", f"{_PK}:571")
NTT = Kernel("ntt", "ntt.cu", f"{_PK}:640")
G1_FIXED_BASE = Kernel("g1_fixed_base", "g1.cu", f"{_PK}:961")
MSM_BUCKET_SUM = Kernel("msm_bucket_sum", "msm.cu", f"{_PK}:1254")
MSM_WINDOW = Kernel("msm_window_reduce", "msm.cu", f"{_PK}:1408")
AFF_PRE = Kernel("aff_pre", "g1_affine.cu", f"{_PK}:1055")
AFF_POST = Kernel("aff_post", "g1_affine.cu", f"{_PK}:1096")
G1_ADD = Kernel("g1_add", "g1_ops.cu", f"{_PK}:824")
G1_DBL = Kernel("g1_dbl", "g1_ops.cu", f"{_PK}:810")
G1_TO_AFFINE = Kernel("g1_to_affine", "g1_ops.cu", f"{_PK}:867")
CRS_DECODE = Kernel("crs_decode", "crs_decode.cu",
                    "none: tokamak_zk_evm_tpu/io/rkyv_crs.py:190 decodes on the host")
KERNELS = (FR_EW, FQ_EW, FIELD_INV, BATCH_INV, FR_SCAN, NTT, G1_FIXED_BASE, MSM_BUCKET_SUM,
           MSM_WINDOW, AFF_PRE, AFF_POST, G1_ADD, G1_DBL, G1_TO_AFFINE, CRS_DECODE)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def on_card(*tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (take
    the plain version); raise for anything else or a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"no kernel route for devices {sorted(kinds)}")


def _check(t: torch.Tensor, rows: int, name: str) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != rows or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous int32 [{rows}, B] tensor, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K1: elementwise field ops
# ---------------------------------------------------------------------------

_OPS = {"add": 0, "sub": 1, "mul": 2, "neg": 3}


def _b_index(Ba: int, Bb: int, rep: int, device) -> torch.Tensor:
    return (torch.arange(Ba, device=device) // rep) % Bb


def plain_field_ew(field: int, op: str, a, b=None, rep: int = 1):
    """Plain version of K1: out[i] = a[i] (op) b[(i / rep) % Bb]."""
    F = _FR if field == 0 else _FQ
    x = a.to(torch.int64)
    if op == "neg":
        return limbs.neg(F, x).to(torch.int32)
    y = b.to(torch.int64)
    if y.shape[1] != x.shape[1]:
        y = y[:, _b_index(x.shape[1], y.shape[1], rep, y.device)]
    fn = {"add": limbs.add, "sub": limbs.sub, "mul": limbs.mul}[op]
    return fn(F, x, y).to(torch.int32)


def _field_ew(field: int, op: str, a, b=None, rep: int = 1):
    L = FR_L if field == 0 else FQ_L
    _check(a, L, "a")
    if b is not None:
        _check(b, L, "b")
        if rep < 1:
            raise ValueError("rep must be >= 1")
    if not (on_card(a) if b is None else on_card(a, b)):
        return plain_field_ew(field, op, a, b, rep)
    out = torch.empty_like(a)
    Bb = a.shape[1] if b is None else b.shape[1]
    build.call("field_ew", "tzk_field_ew", field, _OPS[op], _ptr(a), _ptr(b), _ptr(out),
               a.shape[1], Bb, rep, _stream(a))
    (FR_EW if field == 0 else FQ_EW).launches += 1
    return out


def fr_add(a, b, rep=1):
    return _field_ew(0, "add", a, b, rep)


def fr_sub(a, b, rep=1):
    return _field_ew(0, "sub", a, b, rep)


def fr_mul(a, b, rep=1):
    return _field_ew(0, "mul", a, b, rep)


def fr_neg(a):
    return _field_ew(0, "neg", a)


def fq_add(a, b, rep=1):
    return _field_ew(1, "add", a, b, rep)


def fq_sub(a, b, rep=1):
    return _field_ew(1, "sub", a, b, rep)


def fq_mul(a, b, rep=1):
    return _field_ew(1, "mul", a, b, rep)


def fq_neg(a):
    return _field_ew(1, "neg", a)


# ---------------------------------------------------------------------------
# K2: inversion
# ---------------------------------------------------------------------------

# K2's batch inversion: batches up to BINV_EACH[field] elements invert each
# element with its own extended gcd (`field_inv`, one launch); wider ones run
# Montgomery's trick over tiles of BINV_THREADS x per-thread elements (up,
# the tile totals through `field_inv`, down: three launches).  Both choices
# come from `utils/bench_inv.py`'s table on one H100: one gcd each is the
# faster route up to 2^16 elements in either field, and above it the tiled
# one is fastest with about B / 2^16 elements a thread (some 256 tiles), up
# to 32.
BINV_THREADS = 256  # csrc/field_inv.cu THREADS
BINV_EACH = {0: 1 << 16, 1: 1 << 16}
BINV_MAX_PER_THREAD = 32


def binv_per_thread(field: int, B: int) -> int:
    """Elements a thread walks in the tiled batch inversion of B elements:
    the power of two at or below B / 2^16, within [1, BINV_MAX_PER_THREAD]."""
    k = B >> 16
    return 1 if k == 0 else min(BINV_MAX_PER_THREAD, 1 << (k.bit_length() - 1))


def plain_field_inv(field: int, a):
    F = _FR if field == 0 else _FQ
    return limbs.inv(F, a.to(torch.int64)).to(torch.int32)


def field_inv(field: int, a):
    """Per-element inverse (one extended gcd a thread on the card), 0 -> 0."""
    _check(a, FR_L if field == 0 else FQ_L, "a")
    if not on_card(a):
        return plain_field_inv(field, a)
    out = torch.empty_like(a)
    build.call("field_inv", "tzk_field_inv", field, _ptr(a), _ptr(out), a.shape[1],
               _stream(a))
    FIELD_INV.launches += 1
    return out


def fr_inv(a):
    return field_inv(0, a)


def fq_inv(a):
    return field_inv(1, a)


PLAIN_BINV_DIRECT = 512  # batches up to this size: one inversion per element
PLAIN_BINV_CHUNK = 16  # elements a vector lane walks in the plain version


def plain_batch_inv(field: int, a):
    """Plain version of K2's batch inversion: a chunked walk, one vector lane
    per chunk of PLAIN_BINV_CHUNK contiguous elements (the kernel's tiles
    give the same values).  A small batch inverts element by element
    instead: the walk's 48 dependent products cost more than a few hundred
    host inversions."""
    F = _FR if field == 0 else _FQ
    x = a.to(torch.int64)
    L, B = x.shape
    if B == 0:
        return a.clone()
    if B <= PLAIN_BINV_DIRECT:
        return limbs.inv(F, x).to(torch.int32)
    K = PLAIN_BINV_CHUNK
    nch = -(-B // K)
    pad = nch * K - B
    xp = torch.cat([x, x.new_zeros(L, pad)], 1).reshape(L, nch, K)
    zero = (xp == 0).all(0)  # [nch, K]
    one = F.one(x.device).expand(L, nch)
    acc = one.clone()
    pre = []
    for k in range(K):
        pre.append(acc)
        prod = limbs.mul(F, acc, xp[:, :, k])
        acc = torch.where(zero[None, :, k], acc, prod)
    inv = limbs.inv(F, acc)
    out = [None] * K
    for k in range(K - 1, -1, -1):
        o = limbs.mul(F, pre[k], inv)
        out[k] = torch.where(zero[None, :, k], torch.zeros_like(o), o)
        inv = torch.where(zero[None, :, k], inv, limbs.mul(F, inv, xp[:, :, k]))
    res = torch.stack(out, 2).reshape(L, nch * K)[:, :B]
    return res.contiguous().to(torch.int32)


def batch_inv(field: int, a):
    """Montgomery batch inversion over the batch axis, 0 -> 0: up to
    BINV_EACH[field] elements one inversion each (one launch); above, tile
    prefixes and totals, the totals' inversions, the walk back (three)."""
    _check(a, FR_L if field == 0 else FQ_L, "a")
    if not on_card(a):
        return plain_batch_inv(field, a)
    B = a.shape[1]
    if B <= BINV_EACH[field]:
        return field_inv(field, a)
    K = binv_per_thread(field, B)
    out = torch.empty_like(a)
    # tile totals are products of nonzero elements (or one), so never zero
    tot = torch.empty((a.shape[0], -(-B // (BINV_THREADS * K))), dtype=torch.int32,
                      device=a.device)
    s = _stream(a)
    build.call("field_inv", "tzk_batch_inv_up", field, _ptr(a), _ptr(out), _ptr(tot), B, K, s)
    BATCH_INV.launches += 1
    tinv = field_inv(field, tot)
    build.call("field_inv", "tzk_batch_inv_down", field, _ptr(a), _ptr(out), _ptr(tinv), B, K,
               s)
    BATCH_INV.launches += 1
    return out


def fr_batch_inv(a):
    return batch_inv(0, a)


def fq_batch_inv(a):
    return batch_inv(1, a)


# ---------------------------------------------------------------------------
# B6: Fr product scan
# ---------------------------------------------------------------------------

SCAN_K = 8  # csrc/fr_scan.cu K, the positions a thread scans
SCAN_TILE = 1024  # csrc/fr_scan.cu TILE = THREADS x K, the positions a block scans
SCAN_GROUP = 32  # csrc/fr_scan.cu GROUP, the tiles of a group


def scan_status_words(B: int) -> int:
    """Words of fr_scan's zeroed scratch for B elements: the tile counter; a
    flag and 8 aggregate words a tile; a flag, 8 aggregate and 8 prefix
    words a group of SCAN_GROUP tiles."""
    nt = -(-B // SCAN_TILE)
    return 1 + 9 * nt + 17 * -(-nt // SCAN_GROUP)


def plain_fr_scan(a, reverse: bool = False):
    """Plain version of B6: Hillis-Steele doubling over the plain Fr product
    (flipped for a suffix scan)."""
    x = a.to(torch.int64)
    if reverse:
        x = torch.flip(x, [1])
    B = x.shape[1]
    d = 1
    while d < B:
        x = torch.cat([x[:, :d], limbs.mul(_FR, x[:, d:], x[:, : B - d])], 1)
        d *= 2
    if reverse:
        x = torch.flip(x, [1])
    return x.to(torch.int32).contiguous()


def fr_scan(a, reverse: bool = False):
    """Inclusive product over the batch axis of `a` [16, B]: out[i] = a[0]
    ... a[i], or a[i] ... a[B-1] with `reverse`.  One launch at every width:
    the tiles pass their products on through status records (a decoupled
    look-back), which this call allocates zeroed with the tile counter, so
    no call reads another's."""
    _check(a, FR_L, "a")
    if not on_card(a):
        return plain_fr_scan(a, reverse)
    B = a.shape[1]
    out = torch.empty_like(a)
    if B == 0:
        return out
    words = scan_status_words(B)
    status = torch.zeros(words, dtype=torch.int32, device=a.device)
    build.call("fr_scan", "tzk_fr_scan", _ptr(a), _ptr(out), _ptr(status), words, B,
               int(reverse), _stream(a))
    FR_SCAN.launches += 1
    return out


def fr_prefix_prod(a):
    return fr_scan(a)


def fr_suffix_prod(a):
    return fr_scan(a, reverse=True)


# ---------------------------------------------------------------------------
# K3: NTT
# ---------------------------------------------------------------------------


def _bitrev(n: int, device) -> torch.Tensor:
    logn = n.bit_length() - 1
    j = torch.arange(n, device=device)
    r = torch.zeros_like(j)
    for t in range(logn):
        r |= ((j >> t) & 1) << (logn - 1 - t)
    return r


NTT_MAX_N = 1 << 22  # the most the kernel's two passes hold; longer: ntt_split


def plain_ntt(data, pows, scale=None, axis=2):
    """Plain version of K3: a transpose brings `axis` last, then bit
    reversal, radix-2 DIT stages and `scale`."""
    x = data.to(torch.int64)
    if axis == 1:
        x = x.transpose(1, 2)
    L, batch, n = x.shape
    inv_perm = torch.argsort(_bitrev(n, x.device))
    x = x[:, :, inv_perm]  # x[r(j)] = data[j]
    w = pows.to(torch.int64)
    m = 1
    while m < n:
        v = x.reshape(L, batch, n // (2 * m), 2, m)
        lo = v[:, :, :, 0, :].reshape(L, -1)
        hi = v[:, :, :, 1, :]
        tw = w[:, :: n // (2 * m)][:, :m]  # [L, m]
        tw = tw[:, None, None, :].expand(L, batch, n // (2 * m), m).reshape(L, -1)
        hi = limbs.mul(_FR, hi.reshape(L, -1), tw)
        a = limbs.add(_FR, lo, hi).reshape(L, batch, n // (2 * m), 1, m)
        b = limbs.sub(_FR, lo, hi).reshape(L, batch, n // (2 * m), 1, m)
        x = torch.cat([a, b], 3).reshape(L, batch, n)
        m *= 2
    if scale is not None:
        sc = scale.to(torch.int64).expand(L, batch * n)
        x = limbs.mul(_FR, x.reshape(L, -1), sc).reshape(L, batch, n)
    if axis == 1:
        x = x.transpose(1, 2)
    return x.to(torch.int32).contiguous()


def fr_ntt(data, pows, scale=None, axis=2, inplace=False):
    """NTT of the grid `data` [16, X, Y] (natural order) along `axis` (1 or
    2), of length n = data.shape[axis]:
        out[k] = scale * sum_j data[j] * w^(jk)
    with twiddles pows [16, n] = w^j and `scale` None or [16, 1] (an
    inverse transform's n^-1).  Natural order out, into a new tensor, or
    over `data` with `inplace`.  On the card a transform longer than
    NTT_MAX_N, the most the kernel's two passes hold, runs as `ntt_split`."""
    if data.dim() != 3 or data.shape[0] != FR_L or axis not in (1, 2):
        raise ValueError("fr_ntt: want data [16, X, Y] and axis 1 or 2")
    n = data.shape[axis]
    if n & (n - 1) or n < 2:
        raise ValueError(f"fr_ntt: n = {n} is not a power of two >= 2")
    if pows.shape != (FR_L, n) or (scale is not None and scale.shape != (FR_L, 1)):
        raise ValueError("fr_ntt: want pows [16, n] and scale None or [16, 1]")
    tensors = [t for t in (data, pows, scale) if t is not None]
    if not all(t.is_contiguous() and t.dtype == torch.int32 for t in tensors):
        raise ValueError("fr_ntt: inputs must be contiguous int32")
    if not on_card(*tensors):
        out = plain_ntt(data, pows, scale, axis)
        return data.copy_(out) if inplace else out
    if n > NTT_MAX_N:
        out = ntt_split(data, pows, scale, axis, 1 << (n.bit_length() // 2))
        return data.copy_(out) if inplace else out
    X, Y = data.shape[1:]
    A, C = (X, 1) if axis == 2 else (1, Y)
    passes = build.lib("ntt").tzk_ntt_passes(n, C)
    # one pass reads a block's whole tile before it writes it back, and two
    # go through `tmp`, so `out` may be `data`
    out = data if inplace else torch.empty_like(data)
    tmp = torch.empty_like(data) if passes == 2 else None
    build.call("ntt", "tzk_ntt", _ptr(data), _ptr(out), _ptr(tmp), _ptr(pows), _ptr(scale),
               A, n, C, _stream(data))
    NTT.launches += 1
    return out


def ntt_split(data, pows, scale=None, axis=2, n1=2):
    """`fr_ntt`'s transform as a four-step split n = n2 * n1.  With
    j = j2 n1 + j1 and k = k1 n2 + k2:
        out[k] = sum_j1 w^(n2 j1 k1) w^(j1 k2) sum_j2 data[j] w^(n1 j2 k2),
    so: transforms of n2 points along j2 (`fr_ntt`), a K1 product by the
    twiddles w^(j1 k2), a transpose that brings j1 first, and transforms of
    n1 points along it (`fr_ntt`, with the scale).  Rows (axis 2) are
    transposed into columns and back.  A new tensor out."""
    n = data.shape[axis]
    if n1 < 2 or n % n1 or n1 == n:
        raise ValueError(f"ntt_split: n1 = {n1} does not split n = {n}")
    if axis == 2:
        cols = data.transpose(1, 2).contiguous()
        return ntt_split(cols, pows, scale, 1, n1).transpose(1, 2).contiguous()
    n2, Q = n // n1, data.shape[2]
    y = fr_ntt(data.reshape(FR_L, n2, n1 * Q), pows[:, ::n1].contiguous(), axis=1)
    k2 = torch.arange(n2, device=data.device)
    j1 = torch.arange(n1, device=data.device)
    twiddles = pows[:, (k2[:, None] * j1[None, :]).reshape(-1)]  # [16, n2 n1]
    y = fr_mul(y.reshape(FR_L, -1), twiddles, rep=Q)
    z = y.reshape(FR_L, n2, n1, Q).transpose(1, 2).contiguous().reshape(FR_L, n1, n2 * Q)
    out = fr_ntt(z, pows[:, ::n2].contiguous(), scale, axis=1, inplace=True)
    return out.reshape(data.shape)


# ---------------------------------------------------------------------------
# G1 point formulas over an arithmetic: the plain versions (limbs on int64)
# of B13's kernels and of the MSM stages.
# ---------------------------------------------------------------------------


class _Arith:
    def __init__(self, mul, add, sub, dtype):
        self._mul, self.add, self.sub, self.dtype = mul, add, sub, dtype

    def muls(self, *pairs):
        """Independent products in one call."""
        n = pairs[0][0].shape[1]
        if n == 0:
            return tuple(p for p, _ in pairs)
        a = torch.cat([p for p, _ in pairs], 1)
        b = torch.cat([q for _, q in pairs], 1)
        return self._mul(a.contiguous(), b.contiguous()).split(n, 1)

    def one(self, n, device):
        return _FQ.one(device).expand(FQ_L, n).to(self.dtype).contiguous()


_PLAIN = _Arith(lambda a, b: limbs.mul(_FQ, a, b), lambda a, b: limbs.add(_FQ, a, b),
                lambda a, b: limbs.sub(_FQ, a, b), torch.int64)


def _sel(mask, a, b):
    return torch.where(mask[None, :], a, b)


def _is_zero(v):
    return (v == 0).all(0)


def _inf(ar, n, device):
    one = ar.one(n, device)
    return (one, one, torch.zeros_like(one))


def jac_dbl(ar, p):
    """dbl-2009-l (Z3 = 2 Y Z: Y = 0 or Z = 0 gives infinity)."""
    X, Y, Z = p
    A, Bq = ar.muls((X, X), (Y, Y))
    (C,) = ar.muls((Bq, Bq))
    t = ar.add(X, Bq)
    (t,) = ar.muls((t, t))
    D = ar.sub(ar.sub(t, A), C)
    D = ar.add(D, D)
    E = ar.add(ar.add(A, A), A)
    Fv, YZ = ar.muls((E, E), (Y, Z))
    X3 = ar.sub(Fv, ar.add(D, D))
    C8 = ar.add(C, C)
    C8 = ar.add(C8, C8)
    C8 = ar.add(C8, C8)
    (t,) = ar.muls((E, ar.sub(D, X3)))
    return X3, ar.sub(t, C8), ar.add(YZ, YZ)


def _finish_add(ar, p, q, r, H, R, pinf, qinf):
    """Apply the equal / opposite / infinity cases to a generic add r."""
    X3, Y3, Z3 = r
    hz, rz = _is_zero(H), _is_zero(R)
    live = ~pinf & ~qinf
    dbl = hz & rz & live
    if bool(dbl.any()):
        idx = torch.nonzero(dbl).squeeze(1)
        D = jac_dbl(ar, tuple(c[:, idx] for c in p))
        X3, Y3, Z3 = (c.clone() for c in (X3, Y3, Z3))
        for c, d in zip((X3, Y3, Z3), D):
            c[:, idx] = d
    ix, iy, iz = _inf(ar, X3.shape[1], X3.device)
    cancel = hz & ~rz & live
    X3, Y3, Z3 = _sel(cancel, ix, X3), _sel(cancel, iy, Y3), _sel(cancel, iz, Z3)
    X3, Y3, Z3 = (_sel(qinf, pc, c) for pc, c in zip(p, (X3, Y3, Z3)))
    X3, Y3, Z3 = (_sel(pinf, qc, c) for qc, c in zip(q, (X3, Y3, Z3)))
    return X3, Y3, Z3


def jac_add(ar, p, q):
    """Complete jacobian add, lane by lane."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1, Z2Z2 = ar.muls((Z1, Z1), (Z2, Z2))
    U1, U2, t2, t1 = ar.muls((X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2), (Z1, Z1Z1))
    S1, S2 = ar.muls((Y1, t2), (Y2, t1))
    H = ar.sub(U2, U1)
    R = ar.sub(S2, S1)
    HH, RR, Z1Z2 = ar.muls((H, H), (R, R), (Z1, Z2))
    HHH, V, Z3 = ar.muls((H, HH), (U1, HH), (Z1Z2, H))
    X3 = ar.sub(ar.sub(RR, HHH), ar.add(V, V))
    Rt, S1H = ar.muls((R, ar.sub(V, X3)), (S1, HHH))
    r = (X3, ar.sub(Rt, S1H), Z3)
    return _finish_add(ar, p, q, r, H, R, _is_zero(Z1), _is_zero(Z2))


def mixed_add(ar, p, qx, qy):
    """Complete add of jacobian p and finite affine (qx, qy)."""
    X1, Y1, Z1 = p
    (Z1Z1,) = ar.muls((Z1, Z1))
    U2, t = ar.muls((qx, Z1Z1), (Z1, Z1Z1))
    (S2,) = ar.muls((qy, t))
    H = ar.sub(U2, X1)
    R = ar.sub(S2, Y1)
    HH, RR = ar.muls((H, H), (R, R))
    HHH, V, Z3 = ar.muls((H, HH), (X1, HH), (Z1, H))
    X3 = ar.sub(ar.sub(RR, HHH), ar.add(V, V))
    Rt, YH = ar.muls((R, ar.sub(V, X3)), (Y1, HHH))
    r = (X3, ar.sub(Rt, YH), Z3)
    q = (qx, qy, ar.one(qx.shape[1], qx.device))
    none = torch.zeros_like(_is_zero(Z1))
    return _finish_add(ar, p, q, r, H, R, _is_zero(Z1), none)


def _expand_rep(q, Ba, rep):
    Bb = q[0].shape[1]
    if Bb == Ba:
        return q
    idx = _b_index(Ba, Bb, rep, q[0].device)
    return tuple(c[:, idx].contiguous() for c in q)


def _dbl_complete(ar, p):
    """`jac_dbl` with infinity in, infinity (1, 1, 0) out."""
    X, Y, Z = jac_dbl(ar, p)
    ix, iy, iz = _inf(ar, X.shape[1], X.device)
    inf = _is_zero(p[2])
    return _sel(inf, ix, X), _sel(inf, iy, Y), _sel(inf, iz, Z)


def _int64(p):
    return tuple(c.to(torch.int64) for c in p)


def _int32(p):
    return tuple(c.to(torch.int32) for c in p)


def plain_g1_add(p, q, rep=1):
    """Plain version of `g1_add`: the complete add on int64 limbs."""
    q = _expand_rep(q, p[0].shape[1], rep)
    return _int32(jac_add(_PLAIN, _int64(p), _int64(q)))


def plain_g1_dbl(p):
    """Plain version of `g1_dbl`."""
    return _int32(_dbl_complete(_PLAIN, _int64(p)))


def plain_g1_affine_scale(p, zi):
    """Plain version of `g1_affine_scale`."""
    X, Y, Z = p
    zi = zi.to(torch.int64)
    zi2 = limbs.mul(_FQ, zi, zi)
    x = limbs.mul(_FQ, X.to(torch.int64), zi2)
    y = limbs.mul(_FQ, Y.to(torch.int64), limbs.mul(_FQ, zi2, zi))
    return x.to(torch.int32), y.to(torch.int32), _is_zero(Z).to(torch.int32)


def plain_g1_to_affine(p):
    """Plain version of `g1_to_affine`."""
    return plain_g1_affine_scale(p, plain_batch_inv(1, p[2]))


def _check_pt(p, name: str) -> None:
    for c, k in zip(p, "XYZ"):
        _check(c, FQ_L, f"{name}.{k}")
    if not p[0].shape == p[1].shape == p[2].shape:
        raise ValueError(f"{name}: coordinates of different shapes")


def g1_add(p, q, rep=1):
    """Complete jacobian add of [24, B] point triples, q broadcast as K1
    broadcasts b (lane i reads q at i when q is as wide as p, else at
    (i / rep) % Bq): one launch of the B13 add kernel.  The tracer counts
    its lanes (`g1.add_lanes`) on either route."""
    _check_pt(p, "p")
    _check_pt(q, "q")
    if rep < 1:
        raise ValueError("rep must be >= 1")
    timing.count("g1.add_lanes", int(p[0].shape[1]))
    if not on_card(*p, *q):
        return plain_g1_add(p, q, rep)
    out = tuple(torch.empty_like(c) for c in p)
    build.call("g1_ops", "tzk_g1_add", *[_ptr(c) for c in p], *[_ptr(c) for c in q],
               q[0].shape[1], rep, *[_ptr(o) for o in out], p[0].shape[1], _stream(p[0]))
    G1_ADD.launches += 1
    return out


def g1_dbl(p):
    """Jacobian doubling of [24, B] point triples (infinity gives (1, 1, 0)):
    one launch of the B13 doubling kernel (lanes counted, `g1.dbl_lanes`)."""
    _check_pt(p, "p")
    timing.count("g1.dbl_lanes", int(p[0].shape[1]))
    if not on_card(*p):
        return plain_g1_dbl(p)
    out = tuple(torch.empty_like(c) for c in p)
    build.call("g1_ops", "tzk_g1_dbl", *[_ptr(c) for c in p], *[_ptr(o) for o in out],
               p[0].shape[1], _stream(p[0]))
    G1_DBL.launches += 1
    return out


def g1_to_affine(p):
    """Jacobian -> (x, y, inf) by one Fq batch inversion of Z (K2), then one
    launch of the B13 affine kernel (infinity gives x = y = 0, inf = 1)."""
    _check_pt(p, "p")
    if not on_card(*p):
        timing.count("g1.affine_lanes", int(p[0].shape[1]))
        return plain_g1_to_affine(p)
    return g1_affine_scale(p, fq_batch_inv(p[2]))


def g1_affine_scale(p, zi):
    """(X zi^2, Y zi^3, Z == 0) for jacobian p and zi = Z^-1 (0 where Z = 0):
    the B13 affine kernel, one launch (lanes counted, `g1.affine_lanes`)."""
    _check_pt(p, "p")
    _check(zi, FQ_L, "zi")
    timing.count("g1.affine_lanes", int(p[0].shape[1]))
    if not on_card(*p, zi):
        return plain_g1_affine_scale(p, zi)
    X, Y, Z = p
    x, y = torch.empty_like(X), torch.empty_like(Y)
    inf = torch.empty(X.shape[1], dtype=torch.int32, device=X.device)
    build.call("g1_ops", "tzk_g1_affine", _ptr(X), _ptr(Y), _ptr(Z), _ptr(zi), _ptr(x), _ptr(y),
               _ptr(inf), X.shape[1], _stream(X))
    G1_TO_AFFINE.launches += 1
    return x, y, inf


# ---------------------------------------------------------------------------
# K5: batched complete affine add, (0, 0) = infinity
# ---------------------------------------------------------------------------


def _aff_cases(ar, x1, y1, x2, y2):
    """(dx, dy, inf1, inf2, dbl, cancel) of each lane of an affine add."""
    inf1 = _is_zero(x1) & _is_zero(y1)
    inf2 = _is_zero(x2) & _is_zero(y2)
    dx, dy = ar.sub(x2, x1), ar.sub(y2, y1)
    xeq, yeq, live = _is_zero(dx), _is_zero(dy), ~inf1 & ~inf2
    return dx, dy, inf1, inf2, live & xeq & yeq, live & xeq & ~yeq


def plain_aff_pre(x1, y1, x2, y2):
    """Plain version of aff_pre: 2 y1 on doubling lanes, x2 - x1 on add
    lanes, Montgomery one where either operand is infinite or P + (-P)."""
    x1, y1, x2, y2 = (t.to(torch.int64) for t in (x1, y1, x2, y2))
    dx, _, inf1, inf2, dbl, cancel = _aff_cases(_PLAIN, x1, y1, x2, y2)
    den = _sel(dbl, _PLAIN.add(y1, y1), dx)
    return _sel(inf1 | inf2 | cancel, _PLAIN.one(den.shape[1], den.device), den).to(torch.int32)


def plain_aff_post(x1, y1, x2, y2, dinv):
    """Plain version of aff_post: lambda = (3 x1^2 or y2 - y1) / den,
    x3 = lambda^2 - x1 - x2, y3 = lambda (x1 - x3) - y1, then the infinity
    and cancellation selects."""
    x1, y1, x2, y2, dinv = (t.to(torch.int64) for t in (x1, y1, x2, y2, dinv))
    ar = _PLAIN
    _, dy, inf1, inf2, dbl, cancel = _aff_cases(ar, x1, y1, x2, y2)
    (sq,) = ar.muls((x1, x1))
    (lam,) = ar.muls((_sel(dbl, ar.add(ar.add(sq, sq), sq), dy), dinv))
    (lam2,) = ar.muls((lam, lam))
    x3 = ar.sub(ar.sub(lam2, x1), x2)
    (t,) = ar.muls((lam, ar.sub(x1, x3)))
    y3 = ar.sub(t, y1)
    zero = torch.zeros_like(x3)
    ox = _sel(inf1, x2, _sel(inf2, x1, _sel(cancel, zero, x3)))
    oy = _sel(inf1, y2, _sel(inf2, y1, _sel(cancel, zero, y3)))
    return ox.to(torch.int32), oy.to(torch.int32)


def aff_pre(x1, y1, x2, y2):
    for t, n in ((x1, "x1"), (y1, "y1"), (x2, "x2"), (y2, "y2")):
        _check(t, FQ_L, n)
    if not on_card(x1, y1, x2, y2):
        return plain_aff_pre(x1, y1, x2, y2)
    den = torch.empty_like(x1)
    build.call("g1_affine", "tzk_aff_pre", _ptr(x1), _ptr(y1), _ptr(x2), _ptr(y2), _ptr(den),
               x1.shape[1], _stream(x1))
    AFF_PRE.launches += 1
    return den


def aff_post(x1, y1, x2, y2, dinv):
    for t, n in ((x1, "x1"), (y1, "y1"), (x2, "x2"), (y2, "y2"), (dinv, "dinv")):
        _check(t, FQ_L, n)
    if not on_card(x1, y1, x2, y2, dinv):
        return plain_aff_post(x1, y1, x2, y2, dinv)
    ox, oy = torch.empty_like(x1), torch.empty_like(x1)
    build.call("g1_affine", "tzk_aff_post", _ptr(x1), _ptr(y1), _ptr(x2), _ptr(y2),
               _ptr(dinv), _ptr(ox), _ptr(oy), x1.shape[1], _stream(x1))
    AFF_POST.launches += 1
    return ox, oy


def g1_aff_add_batch(p1, p2):
    """Complete affine add of [24, B] point pairs ((0, 0) = infinity): the
    slope denominators, one Fq batch inversion (K2), then the add."""
    (x1, y1), (x2, y2) = p1, p2
    x1, y1, x2, y2 = (t.contiguous() for t in (x1, y1, x2, y2))
    dinv = fq_batch_inv(aff_pre(x1, y1, x2, y2))
    return aff_post(x1, y1, x2, y2, dinv)


# ---------------------------------------------------------------------------
# K4: fixed-base scalar multiplication
# ---------------------------------------------------------------------------


def _fq_limbs(v: int) -> list[int]:
    return FQ.to_limbs(FQ.to_mont(v))


FIXED_BASE_BITS = 12  # window width of the fixed-base table on the card


def fixed_base_windows(bits: int) -> int:
    return -(-255 // bits)


def fixed_base_bits(table) -> int:
    """Window width of a `fixed_base_table`, from its number of points."""
    for bits in range(1, 17):
        if fixed_base_windows(bits) << bits == table.shape[0]:
            return bits
    raise ValueError(f"no window table has {table.shape[0]} points")


@functools.lru_cache(maxsize=4)
def _fixed_base_table_host(gx: int, gy: int):
    """32 x 256 window table: entry wi*256 + d is d * 2^(8 wi) * G, affine
    Montgomery, as [24, 8192] x and y (d = 0: infinity, (0, 0))."""
    from ..host.curve import G1

    W, NWIN, TBL = 8, 32, 256
    tx = np.zeros((FQ_L, NWIN * TBL), np.int32)
    ty = np.zeros((FQ_L, NWIN * TBL), np.int32)
    base = G1.from_affine((gx, gy))
    for wi in range(NWIN):
        acc = G1.infinity
        pts = []
        for _ in range(1, TBL):
            acc = G1.add(acc, base)
            pts.append(acc)
        run, pre = 1, []
        for p in pts:
            pre.append(run)
            run = run * p[2] % Q_MOD
        inv = pow(run, -1, Q_MOD)
        for d in range(TBL - 1, 0, -1):
            p = pts[d - 1]
            zi = pre[d - 1] * inv % Q_MOD
            inv = inv * p[2] % Q_MOD
            zi2 = zi * zi % Q_MOD
            e = wi * TBL + d
            tx[:, e] = _fq_limbs(p[0] * zi2 % Q_MOD)
            ty[:, e] = _fq_limbs(p[1] * zi2 % Q_MOD * zi % Q_MOD)
        for _ in range(W):
            base = G1.double(base)
    return tx, ty


@functools.lru_cache(maxsize=2)
def _window_scalars(bits: int) -> np.ndarray:
    """Canonical limbs [16, nwin << bits] of the scalars d 2^(bits w) mod r,
    at column (w << bits) + d."""
    nwin, size = fixed_base_windows(bits), 1 << bits
    out = np.zeros((FR_L, nwin * size), np.int32)
    d = np.arange(size, dtype=np.int64)
    for w in range(nwin):
        o, cols = bits * w, slice(w * size, (w + 1) * size)
        if (size - 1) << o < R_MOD:
            v = d << (o % 16)
            out[o // 16, cols] = v & 0xFFFF
            if o // 16 + 1 < FR_L:
                out[o // 16 + 1, cols] = v >> 16
        else:  # the top window reaches past r
            out[:, cols] = np.array([FR.to_limbs((k << o) % R_MOD) for k in range(size)]).T
    return out


def fixed_base_table(gx: int, gy: int, device, bits: int | None = None):
    """Window table of G for `g1_fixed_base` on `device`, affine points
    packed point-major ([nwin << bits, 24] int32 words, `pack_points`):
    entry (w << bits) + d is d 2^(bits w) G, and d = 0 holds infinity as
    (0, 0), never read.  The 8-bit table (32 x 256) is built on the host; a
    wider one by `g1_fixed_base` itself over the scalars d 2^(bits w)
    against the 8-bit table, made affine by `g1_to_affine` (K2), on
    `device`'s kind.  `bits` defaults to FIXED_BASE_BITS on the card and to
    8 on the CPU, where the wide table's plain build takes ~20 s.  Once
    built, a table is kept on the host and moved to `device` at each call,
    so it holds no device memory between setups."""
    kind = torch.device(device).type
    if bits is None:
        bits = FIXED_BASE_BITS if kind == "cuda" else 8
    return _fixed_base_table_packed(gx, gy, bits, kind).to(device)


@functools.lru_cache(maxsize=4)
def _fixed_base_table_packed(gx: int, gy: int, bits: int, kind: str) -> torch.Tensor:
    if bits == 8:
        tx, ty = _fixed_base_table_host(gx, gy)
        return pack_points(torch.from_numpy(tx), torch.from_numpy(ty))
    base = fixed_base_table(gx, gy, kind, 8)
    scalars = torch.as_tensor(_window_scalars(bits), device=kind)
    x, y, _ = g1_to_affine(g1_fixed_base(scalars, base))
    return pack_points(x, y).cpu()


def plain_g1_fixed_base(scalars, table, bits: int):
    """Plain version of the fixed-base kernel: for each window, complete
    mixed adds of the table points of the scalars whose digit is nonzero."""
    B = scalars.shape[1]
    s = scalars.to(torch.int64)
    s = torch.cat([s, torch.zeros_like(s[:1])])  # limb l + 1 of the top digit
    tx, ty = _plain_unpack(table, 2)
    acc = [c.clone() for c in _inf(_PLAIN, B, s.device)]
    for w in range(fixed_base_windows(bits)):
        o = bits * w
        d = ((s[o // 16] | (s[o // 16 + 1] << 16)) >> (o % 16)) & ((1 << bits) - 1)
        use = torch.nonzero(d != 0).squeeze(1)
        if use.numel() == 0:
            continue
        e = (w << bits) + d[use]
        nxt = mixed_add(_PLAIN, tuple(c[:, use] for c in acc), tx[:, e], ty[:, e])
        for c, v in zip(acc, nxt):
            c[:, use] = v
    return tuple(c.to(torch.int32) for c in acc)


def g1_fixed_base(scalars, table):
    """out[i] = k_i * G (jacobian [24, B] x 3) for canonical scalars [16, B]
    and a window table of G (`fixed_base_table`, of any width)."""
    _check(scalars, FR_L, "scalars")
    _check_packed(table, AFF_WORDS, "table")
    bits = fixed_base_bits(table)
    if not on_card(scalars, table):
        return plain_g1_fixed_base(scalars, table, bits)
    B = scalars.shape[1]
    out = [torch.empty((FQ_L, B), dtype=torch.int32, device=scalars.device) for _ in range(3)]
    build.call("g1", "tzk_g1_fixed_base", _ptr(scalars), _ptr(table), bits,
               *[_ptr(o) for o in out], B, _stream(scalars))
    G1_FIXED_BASE.launches += 1
    return tuple(out)


# ---------------------------------------------------------------------------
# K4: MSM device stages (csrc/msm.cu)
# ---------------------------------------------------------------------------

MSM_CHUNK = 32  # entries per thread in one bucket-sum pass
MSM_SEG = 16  # buckets per thread in the first window-reduce level
MSM_SEG_UP = 2  # segment totals per thread in the levels above it
AFF_WORDS = 2 * (FQ_L // 2)  # an affine point: X then Y, 12 words each
JAC_WORDS = 3 * (FQ_L // 2)  # a jacobian point: X, Y, Z


def pack_points(*coords):
    """Limb-major [24, n] int32 coordinates -> point-major [n, 12 * k] int32
    words (two 16-bit limbs a word, low limb first; the coordinates of a
    point one after another), the layout of K4's MSM stages."""
    words = torch.cat([c[0::2] | (c[1::2] << 16) for c in coords])
    return words.t().contiguous()


def unpack_points(packed, k: int):
    """Inverse of `pack_points`: [n, 12 * k] words -> k limb-major [24, n]."""
    w = packed.t()
    limbs = torch.stack([w & 0xFFFF, (w >> 16) & 0xFFFF], 1).reshape(2 * w.shape[0], -1)
    return tuple(limbs[FQ_L * i: FQ_L * (i + 1)].contiguous() for i in range(k))


def _check_packed(t: torch.Tensor, words: int, name: str) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != words or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous int32 [n, {words}] tensor, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _check_index(*tensors) -> None:
    for t in tensors:
        if t is not None and (t.dtype != torch.int64 or not t.is_contiguous()):
            raise ValueError("MSM indices and offsets must be contiguous int64 tensors")


def _segmented_sum(ar, pts, counts):
    """Lanes grouped by segment (segment k owns counts[k] consecutive lanes)
    -> one jacobian sum per segment (infinity when empty): pairwise levels
    over the ranks inside each segment, so the adds total about one per
    lane."""
    dev = pts[0].device
    n_seg = counts.shape[0]
    first = torch.cumsum(counts, 0) - counts
    seg_id = torch.repeat_interleave(torch.arange(n_seg, device=dev), counts)
    rank = torch.arange(seg_id.shape[0], device=dev) - first[seg_id]
    length = counts[seg_id]
    pts = [c.clone() for c in pts]
    maxlen = int(counts.max()) if n_seg else 0
    step = 1
    while step < maxlen:
        i = torch.nonzero(((rank % (2 * step)) == 0) & (rank + step < length)).squeeze(1)
        s = jac_add(ar, tuple(c[:, i] for c in pts), tuple(c[:, i + step] for c in pts))
        for c, v in zip(pts, s):
            c[:, i] = v
        step *= 2
    out = [c.clone() for c in _inf(ar, n_seg, dev)]
    has = torch.nonzero(counts > 0).squeeze(1)
    for o, c in zip(out, pts):
        o[:, has] = c[:, first[has]]
    return tuple(out)


def _plain_pack(pts):
    return pack_points(*(c.to(torch.int32) for c in pts))


def _plain_unpack(packed, k):
    return tuple(c.to(torch.int64) for c in unpack_points(packed, k))


def plain_msm_bucket_sum(mode, pts, idx, start, length):
    """Plain version of the bucket-sum kernel: chunk c sums entries
    [start[c], start[c] + length[c]); -> packed jacobian [nchunks, 36]."""
    dev = pts.device
    nch = start.shape[0]
    chunk = torch.repeat_interleave(torch.arange(nch, device=dev), length)
    first = torch.cumsum(length, 0) - length
    ent = start[chunk] + torch.arange(chunk.shape[0], device=dev) - first[chunk]
    if mode == 0:  # finite affine points (the plan dropped the infinite ones)
        X, Y = _plain_unpack(pts[idx[ent]], 2)
        P = (X, Y, _PLAIN.one(X.shape[1], dev))
    else:
        P = _plain_unpack(pts[ent], 3)
    return _plain_pack(_segmented_sum(_PLAIN, P, length))


def msm_bucket_sum(mode, pts, idx, start, length):
    """Sum chunks of points: mode 0 gathers the finite affine points idx[e]
    of `pts` ([n, 24] words), mode 1 reads the jacobian points e of `pts`
    ([n, 36] words); chunk c covers entries [start[c], start[c] + length[c]),
    length >= 1.  -> packed jacobian [nchunks, 36]."""
    _check_packed(pts, AFF_WORDS if mode == 0 else JAC_WORDS, "pts")
    _check_index(idx, start, length)
    if not on_card(*(t for t in (pts, idx, start, length) if t is not None)):
        return plain_msm_bucket_sum(mode, pts, idx, start, length)
    nch = start.shape[0]
    out = torch.empty((nch, JAC_WORDS), dtype=torch.int32, device=pts.device)
    if nch == 0:
        return out
    # threads take the chunks longest first, so a warp's chunks match in length
    order = torch.argsort(length, descending=True, stable=True)
    build.call("msm", "tzk_msm_bucket_sum", mode, _ptr(pts), _ptr(idx), _ptr(start),
               _ptr(length), _ptr(order), nch, _ptr(out), _stream(pts))
    MSM_BUCKET_SUM.launches += 1
    return out


def _small_multiples(ar, pts, w):
    """w_i * P_i for small non-negative w (double-and-add over w's bits)."""
    acc = [c.clone() for c in _inf(ar, w.shape[0], w.device)]
    top = int(w.max()).bit_length() if w.numel() else 0
    for bit in range(top - 1, -1, -1):
        acc = list(jac_dbl(ar, acc))  # infinity (Z = 0) stays infinity
        a = torch.nonzero((w >> bit) & 1).squeeze(1)
        s = jac_add(ar, tuple(c[:, a] for c in acc), tuple(c[:, a] for c in pts))
        for c, v in zip(acc, s):
            c[:, a] = v
    return tuple(acc)


def plain_msm_window_reduce(sums, rsum, keys, nseg, seg, shift):
    """Plain version of one window-reduce level: segment t of the buckets
    (keys in [t seg, (t + 1) seg)) -> R_t = sum rsum + sum (b - t seg) B_b,
    by a weighted segmented sum, and S_t = 2^shift sum B_b."""
    seg_id = keys // seg
    counts = torch.bincount(seg_id, minlength=nseg)
    B = _plain_unpack(sums, 3)
    R = _segmented_sum(_PLAIN, _small_multiples(_PLAIN, B, keys - seg_id * seg), counts)
    if rsum is not None:
        R = jac_add(_PLAIN, R, _segmented_sum(_PLAIN, _plain_unpack(rsum, 3), counts))
    S = _segmented_sum(_PLAIN, B, counts)
    for _ in range(shift):
        S = jac_dbl(_PLAIN, S)
    return _plain_pack(R), _plain_pack(S)


def msm_window_reduce(sums, rsum, keys, nseg, seg, shift):
    """One level of the window reduce.  sums: packed jacobian bucket sums
    [m, 36] under ascending keys [m] (key = window * nb + digit, seg | nb);
    rsum: None or [m, 36], the level below's R.  -> packed (R, S), each
    [nseg, 36]: per segment of `seg` keys, R = sum rsum + sum (b - lo) B_b
    and S = 2^shift sum B_b."""
    _check_packed(sums, JAC_WORDS, "sums")
    if rsum is not None:
        _check_packed(rsum, JAC_WORDS, "rsum")
    _check_index(keys)
    if not on_card(*(t for t in (sums, rsum, keys) if t is not None)):
        return plain_msm_window_reduce(sums, rsum, keys, nseg, seg, shift)
    dev = sums.device
    off = torch.searchsorted(keys, torch.arange(nseg + 1, device=dev) * seg)
    out_r, out_s = (torch.empty((nseg, JAC_WORDS), dtype=torch.int32, device=dev)
                    for _ in range(2))
    build.call("msm", "tzk_msm_window_reduce", _ptr(sums), _ptr(rsum), _ptr(keys), _ptr(off),
               nseg, seg, shift, _ptr(out_r), _ptr(out_s), _stream(sums))
    MSM_WINDOW.launches += 1
    return out_r, out_s


def msm_window_bits(n: int) -> int:
    return max(4, min(16, n.bit_length() - 3))


def _digits(scalars, c: int, nwin: int):
    """Canonical [16, N] limbs -> [nwin, N] c-bit digits (int64)."""
    s = scalars.to(torch.int64)
    s = torch.cat([s, torch.zeros_like(s[:2])])  # room for the top window
    rows = []
    for w in range(nwin):
        o = w * c
        li, sh = o // 16, o % 16
        v = (s[li] >> sh) | (s[li + 1] << (16 - sh)) | (s[li + 2] << (32 - sh))
        rows.append(v & ((1 << c) - 1))
    return torch.stack(rows)


def chunk_segments(counts):
    """Cut consecutive segments (segment k holds counts[k] >= 1 entries)
    into chunks of at most MSM_CHUNK entries -> (start, length, per-segment
    chunk counts), int64."""
    dev = counts.device
    nch = (counts + MSM_CHUNK - 1) // MSM_CHUNK
    with timing.sync("msm.chunk_segments"):
        total = int(nch.sum())
    with timing.sync("msm.repeat_interleave"):
        seg_of = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), nch)
    off = torch.arange(total, device=dev) - (torch.cumsum(nch, 0) - nch)[seg_of]
    seg_start = torch.cumsum(counts, 0) - counts
    start = (seg_start[seg_of] + off * MSM_CHUNK).contiguous()
    length = torch.clamp(counts[seg_of] - off * MSM_CHUNK, max=MSM_CHUNK).contiguous()
    return start, length, nch


def segment_sums(bucket_sum, mode, pts, idx, counts):
    """One packed jacobian sum per segment of consecutive entries: bounded
    chunks per pass, then the chunk partials again, until every segment is
    one point."""
    while True:
        start, length, nch = chunk_segments(counts)
        pts = bucket_sum(mode, pts, idx, start, length)
        if start.shape[0] == counts.shape[0]:
            return pts
        mode, idx, counts = 1, None, nch


def window_sums(window_reduce, sums, keys, nwin: int, nb: int, seg: int = MSM_SEG,
                seg_up: int = MSM_SEG_UP):
    """Bucket sums (packed, ascending keys window * nb + digit) -> one packed
    jacobian point per window, sum_b b * B_b.  With lo = s seg the first
    digit of segment s, sum_b b B_b = sum_s R_s + sum_s s (seg S_s): each
    level of `window_reduce` passes its scaled segment totals up as the next
    level's buckets and its R's as the next level's rsum, until one segment
    spans a window.  The first level takes `seg` buckets a thread; the
    levels above are small and bound by one thread's chain of dependent
    adds, so they take `seg_up` totals a thread (powers of two)."""
    rsum = None
    while True:
        seg = min(seg, nb)
        nseg = nwin * nb // seg
        last = nseg == nwin
        rsum, sums = window_reduce(sums, rsum, keys, nseg, seg,
                                   0 if last else seg.bit_length() - 1)
        if last:
            return rsum
        nb //= seg
        keys = torch.arange(nseg, device=keys.device)
        seg = seg_up


def msm_plan(scalars, pinf):
    """Window size, digits and the sorted (window, bucket) entries of an MSM:
    -> (c, nwin, point index per entry, bucket key per run, run lengths).
    Entries with a zero digit or an infinite point are dropped here.  Tensor
    ops on the input's device, as the JAX package leaves its digit sort to
    XLA."""
    dev = scalars.device
    N = pinf.shape[0]
    c = msm_window_bits(N)
    nwin = -(-255 // c)
    nb = 1 << c
    digits = _digits(scalars, c, nwin)
    live = (digits != 0) & (pinf.to(torch.int64) == 0)[None, :]
    keys = (torch.arange(nwin, device=dev)[:, None] * nb + digits).reshape(-1)
    with timing.sync("msm.nonzero"):
        ent = torch.nonzero(live.reshape(-1)).squeeze(1)
    k = keys[ent]
    order = torch.argsort(k, stable=True)
    pidx = (ent[order] % N).contiguous()
    with timing.sync("msm.unique_consecutive"):
        bucket, counts = torch.unique_consecutive(k[order], return_counts=True)
    return c, nwin, pidx, bucket, counts


def _msm_windows(scalars, px, py, pinf, bucket_sum, window_reduce):
    dev = px.device
    c, nwin, pidx, bucket, counts = msm_plan(scalars, pinf)
    if pidx.numel() == 0:
        return (_int32(_inf(_PLAIN, nwin, dev)), c)
    sums = segment_sums(bucket_sum, 0, pack_points(px, py), pidx, counts)
    del pidx
    return (unpack_points(window_sums(window_reduce, sums, bucket, nwin, 1 << c), 3), c)


def g1_msm_start(scalars, px, py, pinf):
    """Device part of sum_i k_i P_i (Pippenger): canonical scalars [16, N],
    affine Montgomery points [24, N] x 2 and infinity flags [N].  Returns a
    handle for `g1_msm_finish`: one jacobian point per c-bit window."""
    return _msm_windows(scalars, px, py, pinf, msm_bucket_sum, msm_window_reduce)


def plain_g1_msm_start(scalars, px, py, pinf):
    """Plain version of the K4 MSM stages (same plan, plain stages)."""
    return _msm_windows(scalars, px, py, pinf, plain_msm_bucket_sum,
                        plain_msm_window_reduce)


def _jac_host(X, Y, Z):
    """One jacobian point from Montgomery limb columns -> host ints."""
    f = lambda v: FQ.from_mont(FQ.from_limbs(v))  # noqa: E731
    return f(X), f(Y), f(Z)


def g1_msm_finish(handle):
    """Pull the window sums and combine them on the host:
    sum_w 2^(c w) W_w by Horner.  -> jacobian [3, 24] int32 rows (CPU)."""
    from ..host.curve import G1

    (X, Y, Z), c = handle
    with timing.sync("msm.finish_pull"):
        rows = torch.stack([X, Y, Z]).cpu().numpy()  # one pull: [3, 24, nwin]
    exps, pts = [], []
    for w in range(rows.shape[2]):
        Xi, Yi, Zi = _jac_host(rows[0, :, w], rows[1, :, w], rows[2, :, w])
        if Zi == 0:
            continue
        zi = pow(Zi, -1, Q_MOD)
        zi2 = zi * zi % Q_MOD
        exps.append(c * w)
        pts.append((Xi * zi2 % Q_MOD, Yi * zi2 % Q_MOD * zi % Q_MOD))
    acc = G1.msm_pow2(exps, pts)
    out = np.array([FQ.to_limbs(FQ.to_mont(v)) for v in acc], dtype=np.int32)
    return torch.from_numpy(out)


def g1_msm(scalars, px, py, pinf):
    return g1_msm_finish(g1_msm_start(scalars, px, py, pinf))


# ---------------------------------------------------------------------------
# The rkyv CRS decode (csrc/crs_decode.cu)
# ---------------------------------------------------------------------------

G1_ENTRY_BYTES = 96  # an rkyv G1 entry: x then y, 48 little-endian bytes each


@functools.lru_cache(maxsize=None)
def _r2_col(device) -> torch.Tensor:
    """[24, 1] limbs of R^2 mod q (int64)."""
    return torch.tensor(FQ.to_limbs(FQ.R2_mod), dtype=torch.int64, device=device)[:, None]


def plain_crs_decode(raw, n: int):
    """Plain version of the decode: the first n rkyv G1 entries of `raw`
    (uint8) -> x, y [24, n] Montgomery int32 and inf [n] int32 (1 where all
    96 bytes are zero)."""
    b = raw[: G1_ENTRY_BYTES * n].reshape(n, 2 * FQ_L, 2).to(torch.int64)
    lim = (b[:, :, 0] | (b[:, :, 1] << 8)).T  # [48, n]: x's 24 limbs, then y's
    r2 = _r2_col(raw.device).expand(FQ_L, n)  # second: the file's words may reach 2^384
    x = limbs.mul(_FQ, lim[:FQ_L].contiguous(), r2)
    y = limbs.mul(_FQ, lim[FQ_L:].contiguous(), r2)
    inf = (lim == 0).all(0)
    return x.to(torch.int32), y.to(torch.int32), inf.to(torch.int32)


def crs_decode(raw, n: int, ox, oy, oinf, off: int) -> None:
    """Decode the first n rkyv G1 entries of `raw` (uint8, on the outputs'
    device) into columns [off, off + n) of a family's x, y [24, B] and
    inf [B] (int32), in Montgomery form: one launch on the card."""
    _check(ox, FQ_L, "ox")
    _check(oy, FQ_L, "oy")
    B = ox.shape[1]
    if oy.shape[1] != B or oinf.dtype != torch.int32 or tuple(oinf.shape) != (B,) \
            or not oinf.is_contiguous():
        raise ValueError(f"crs_decode: want x, y [24, B] and inf [B] int32, got "
                         f"{tuple(oy.shape)} and {oinf.dtype} {tuple(oinf.shape)}")
    if raw.dtype != torch.uint8 or raw.dim() != 1 or not raw.is_contiguous() \
            or raw.numel() < G1_ENTRY_BYTES * n:
        raise ValueError(f"crs_decode: want a contiguous uint8 buffer of {n} entries, got "
                         f"{raw.dtype} {tuple(raw.shape)}")
    if n < 0 or off < 0 or off + n > B:
        raise ValueError(f"crs_decode: columns [{off}, {off + n}) outside a family of {B}")
    if not on_card(raw, ox, oy, oinf):
        x, y, inf = plain_crs_decode(raw, n)
        ox[:, off:off + n] = x
        oy[:, off:off + n] = y
        oinf[off:off + n] = inf
        return
    if raw.data_ptr() % 16:
        raise ValueError("crs_decode: the entries must start 16-byte aligned")
    build.call("crs_decode", "tzk_crs_decode", _ptr(raw), _ptr(ox), _ptr(oy), _ptr(oinf), n,
               off, B, _stream(raw))
    CRS_DECODE.launches += 1
