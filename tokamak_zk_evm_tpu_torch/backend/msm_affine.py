"""The affine merge-tree MSM: sum_i k_i P_i on K5's batched affine adds.

A port of the JAX package's unpacked MSM configuration
(`tokamak_zk_evm_tpu/backend/pallas_kernels.py`: `_msm_windows_core`
1647-1745, `_aff_tree_sum_last` 1950, `_weighted_bucket_tail` 1963,
`_pow2_chunks` 1985, `_msm_one_start` 2008 and the affine branch of
`g1_msm_finish` 2089-2098), selected through `ops.msm.use_core`.

W = ceil(255 / c) windows of c bits run wb at a time.  Per step, each
window's points are sorted by digit and laid out in bit-reversed order, so
that every level of the merge tree pairs its two contiguous halves, which
are sorted neighbours.  Same-key pairs merge with one batched affine add;
the left partial of every other pair is flushed into its (window, bucket)
column by a scatter and added to the bucket rows with another.  Then
sum_b b * B_b of every window runs by pair halving, and the host combines
the per-window, per-level affine singles as sum 2^(c w + level) single.
Every add is complete (K5 handles doubling, cancellation and infinity), so
repeated points and hot buckets need no special case.

Unlike the TPU version, flushes of merged and dead lanes (key 0) land in a
spare column past the bucket rows instead of bucket 0, so no two writes of a
scatter collide and the bucket rows are deterministic; bucket 0 has weight
zero either way.  Tensor ops run on the inputs' device; the adds dispatch
like every other kernel wrapper (the plain versions on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import FQ
from ..utils import timing
from . import kernels as K

FQ_L = K.FQ_L


def msm_c(n: int) -> int:
    """Window width minimizing the modeled work W(c) * (3 n data movement +
    log2 n bucket-row flushes of 2^c + a weighted tail of 2^(c + 1))."""
    logn = max(1, n.bit_length() - 1)
    best, bestc = None, 16
    for c in range(4, 17):
        W = -(-255 // c)
        cost = W * (3 * n + logn * (1 << c) + (1 << (c + 1)))
        if best is None or cost < best:
            best, bestc = cost, c
    return bestc


def msm_wb(n: int, c: int, W: int) -> int:
    """Windows per step: the gathered [48, wb n] working set stays near 2^23
    lanes and the [24, wb 2^c] bucket rows at most 2^22, balanced so the
    last step is not mostly padding."""
    wb = max(1, min(W, (1 << 23) // n))
    while wb > 1 and wb * (1 << c) > (1 << 22):
        wb //= 2
    steps = -(-W // wb)
    return -(-W // steps)


def pow2_chunks(N: int) -> list[int]:
    """Greedy power-of-two split of a point count above 2^16 (at most three
    chunks, the last one >= 2^15 or the remainder), so that a count just
    above a power of two does not pad to twice its size."""
    if N <= (1 << 16):
        return [N]
    chunks = []
    rem = N
    while True:
        p = 1 << (rem.bit_length() - 1)
        if p == rem or rem < (1 << 15) or len(chunks) >= 2:
            chunks.append(rem)
            break
        chunks.append(p)
        rem -= p
    return chunks


def _halves(a, wb: int, m: int):
    """[24, wb m] window-major -> the per-window left and right halves."""
    v = a.view(a.shape[0], wb, m)
    h = m // 2
    return v[:, :, :h].reshape(a.shape[0], -1), v[:, :, h:].reshape(a.shape[0], -1)


def _flush_add(acc, key, woff, width, px, py):
    """Scatter each lane's point into column woff + key of a fresh all-infinity
    row (key 0 into the spare column `width`) and add the row to acc."""
    idx = torch.where(key == 0, width, key + woff).reshape(-1)
    rows = [torch.zeros((FQ_L, width + 1), dtype=torch.int32, device=px.device)
            .index_copy_(1, idx, p)[:, :width] for p in (px, py)]
    return K.g1_aff_add_batch(acc, rows)


def _step(keys, px, py, br, c: int):
    """One step of wb windows: keys [wb, n] (0 = dead) -> bucket rows
    (x, y) [24, wb 2^c]."""
    wb, n = keys.shape
    nb = 1 << c
    width = wb * nb
    dev = px.device
    key, order = torch.sort(keys, dim=1, stable=True)
    key, order = key[:, br], order[:, br]
    flat = order.reshape(-1)
    dead = (key == 0).reshape(1, -1)
    X = px[:, flat].masked_fill_(dead, 0)
    Y = py[:, flat].masked_fill_(dead, 0)
    woff = torch.arange(wb, device=dev)[:, None] * nb
    bX = torch.zeros((FQ_L, width), dtype=torch.int32, device=dev)
    acc = (bX, bX.clone())
    m = n
    while m > 1:
        h = m // 2
        kl, kr = key[:, :h], key[:, h:]
        lX, rX = _halves(X, wb, m)
        lY, rY = _halves(Y, wb, m)
        same = kl == kr
        mX, mY = K.g1_aff_add_batch((lX, lY), (rX, rY))
        s = same.reshape(1, -1)
        X, Y = torch.where(s, mX, rX), torch.where(s, mY, rY)
        acc = _flush_add(acc, torch.where(same, 0, kl), woff, width, lX, lY)
        key = kr
        m = h
    return _flush_add(acc, key, woff, width, X, Y)


def _tree_sum_last(X, Y):
    """[24, W, m] -> [24, W]: affine pair halving along the last axis."""
    L, W, m = X.shape
    while m > 1:
        h = m // 2
        a1 = [v[:, :, :h].reshape(L, W * h) for v in (X, Y)]
        a2 = [v[:, :, h:].reshape(L, W * h) for v in (X, Y)]
        X, Y = (v.reshape(L, W, h) for v in K.g1_aff_add_batch(a1, a2))
        m = h
    return X[:, :, 0], Y[:, :, 0]


def _weighted_tail(bX, bY):
    """sum_b b B[w, b] for every window by pair halving,
    T(B) = 2 T(B_even + B_odd) + sum(B_odd), with the 2^level weights left
    to the host: [24, W, 2^c] buckets -> singles (x, y) [c, 24, W]."""
    L, W, nb = bX.shape
    sX, sY = [], []
    while nb > 1:
        ev = [v[:, :, 0::2].reshape(L, -1) for v in (bX, bY)]
        od = [v[:, :, 1::2] for v in (bX, bY)]
        x, y = _tree_sum_last(*od)
        sX.append(x)
        sY.append(y)
        nb //= 2
        od = [v.reshape(L, -1) for v in od]
        bX, bY = (v.reshape(L, W, nb) for v in K.g1_aff_add_batch(ev, od))
    return torch.stack(sX), torch.stack(sY)


def _one_start(scalars, px, py, pinf):
    N = px.shape[1]
    n = max(2, 1 << (N - 1).bit_length())
    c = msm_c(n)
    W = -(-255 // c)
    wb = msm_wb(n, c, W)
    steps = -(-W // wb)
    dev = px.device
    if n != N:  # pad with points at infinity
        pad = n - N
        px = torch.nn.functional.pad(px, (0, pad))
        py = torch.nn.functional.pad(py, (0, pad))
        pinf = torch.nn.functional.pad(pinf.to(torch.int32), (0, pad), value=1)
        scalars = torch.nn.functional.pad(scalars, (0, pad))
    keys = K._digits(scalars, c, W)
    keys = torch.where(pinf.to(torch.bool)[None, :], 0, keys)
    keys = torch.cat([keys, keys.new_zeros(steps * wb - W, n)])
    br = K._bitrev(n, dev)
    rows = [_step(keys[s * wb:(s + 1) * wb], px, py, br, c) for s in range(steps)]
    bX = torch.cat([r[0] for r in rows], 1).reshape(FQ_L, steps * wb, 1 << c)
    bY = torch.cat([r[1] for r in rows], 1).reshape(FQ_L, steps * wb, 1 << c)
    sX, sY = _weighted_tail(bX, bY)
    return sX, sY, c


class Handle(list):
    """An affine-tree MSM in flight: per power-of-two chunk, the affine
    singles [c, 24, W'] x 2 and c.  Its type tells `ops.msm.msm_finish`
    which combine to run."""


def g1_msm_start(scalars, px, py, pinf):
    """Device part of sum_i k_i P_i by the affine merge tree: canonical
    scalars [16, N], affine Montgomery points [24, N] x 2 and infinity flags
    [N].  Returns a `Handle` for `g1_msm_finish`."""
    N = px.shape[1]
    out, off = Handle(), 0
    for ch in pow2_chunks(N):
        sl = slice(off, off + ch)
        out.append(_one_start(scalars[:, sl], px[:, sl], py[:, sl], pinf[sl]))
        off += ch
    return out


def g1_msm_finish(handle):
    """Pull the singles of every chunk and combine them on the host:
    sum over windows w and levels l of 2^(c w + l) single[l, w], chunks
    added.  -> jacobian [3, 24] int32 rows (CPU), as K4's finish."""
    from ..host.curve import G1

    acc = G1.infinity
    for sX, sY, c in handle:
        with timing.sync("msm.finish_pull"):
            both = torch.stack([sX, sY]).cpu().numpy()  # one pull: [2, c, 24, W']
        exps, pts = [], []
        for w in range(both.shape[3]):
            for lev in range(both.shape[1]):
                x, y = both[0, lev, :, w], both[1, lev, :, w]
                if not (x.any() or y.any()):
                    continue  # (0, 0) = infinity
                exps.append(c * w + lev)
                pts.append((FQ.from_mont(FQ.from_limbs(x.tolist())),
                            FQ.from_mont(FQ.from_limbs(y.tolist()))))
        acc = G1.add(acc, G1.msm_pow2(exps, pts))
    rows = np.array([FQ.to_limbs(FQ.to_mont(v)) for v in acc], dtype=np.int32)
    return torch.from_numpy(rows)
