"""Peaks of the card and the least work of an MSM and of an NTT.

A roofline share is the least time these inputs allow over the device time
the kernels took: the larger of the bytes bound (inputs read once, outputs
written once) and the integer bound (the least multiply-adds, at the card's
IMAD rate).  The least work must be below what any algorithm needs, so that
no later design reads over 100%:

* MSM: one mixed addition (7 products and 4 squarings in Fq, madd-2007-bl)
  for each point whose scalar is nonzero and which is not the identity; an
  Fq product counted as 81 32-bit multiply-adds (12 limbs of 32 bits under
  two levels of Karatsuba, 3 x 3 x 3 x 3; its reduction not counted).
  Bytes: 32 a scalar read, 96 an affine point read where it counts, 144 a
  jacobian sum written.
* NTT of length n over a batch of b rows: (n / 4) log2 n Fr products a row
  (half the radix-2 count, below radix-4's 3/8 and split radix's 1/3); an
  Fr product 36 multiply-adds (8 limbs, two Karatsuba levels, 3 x 3 x 4).
  Bytes: 32 an element read and 32 written.  A coset's scaling is not
  counted.

Peaks of NVIDIA H100 SXM5 80GB: HBM3 at 3.35 TB/s (NVIDIA's data sheet),
and 64 IMAD a clock on each of 132 SMs at the 1.98 GHz boost clock
(NVIDIA's Hopper architecture paper: 64 INT32 lanes an SM).  Both assume
the 700 W power limit; the run records the card's limit beside them.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bytes_per_s=3.35e12, imad_per_s=64 * 132 * 1.98e9),
}

FQ_PRODUCT_IMAD = 81
FR_PRODUCT_IMAD = 36
MIXED_ADD_PRODUCTS = 11


def msm_least(points: int, live: int) -> tuple[float, float]:
    """(bytes, multiply-adds) of one MSM with `live` points that count."""
    return 32 * points + 96 * live + 144, live * MIXED_ADD_PRODUCTS * FQ_PRODUCT_IMAD


def ntt_least(n: int, batch: int) -> tuple[float, float]:
    log2n = n.bit_length() - 1
    return 64 * n * batch, (n // 4) * log2n * batch * FR_PRODUCT_IMAD


def least_seconds(kind: str, bytes_: float, imad: float) -> float | None:
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return max(bytes_ / peak["bytes_per_s"], imad / peak["imad_per_s"])

