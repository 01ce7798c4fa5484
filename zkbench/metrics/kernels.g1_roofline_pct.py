"""B13's share of the rescaling's roofline, in percent: the least time the
contribution's rescaling needs, over the device seconds B13's kernels took
in the traced window (`ceremony.g1_device_s`: the add, the doubling and the
affine scaling).

The least work is the rescaling's own, not B13's launch plan's, so that a
fused, windowed or otherwise redesigned rescale cannot read over 100%: the
program's counter `p2.rescaled_points` (`models/mpc_setup.py`), each point
multiplied by a scalar drawn from all of Fr.

* Multiply-adds: 124 doublings a point, at 7 Fq products each (2 products
  and 5 squarings, dbl-2009-l for a = 0; an affine doubling with its share
  of a batched inversion is no cheaper), each product
  `roofline.FQ_PRODUCT_IMAD` multiply-adds, as the MSM roofline counts them.
  Any addition chain needs as many doublings as its scalar has bits less
  one; split by the curve's endomorphism (x, y) -> (beta x, y), the one
  speed-up BN254's G1 offers, a 254-bit scalar leaves two halves of about
  127 bits, and 124 leave room for halves that come out a few bits short.
  The adds (a windowed or NAF chain needs few) and the to-affine are not
  counted.
* Bytes: each point read once and written once, 196 bytes a point (x and y
  as 24 int32 limbs, the 4-byte infinity flag).

The least time is the larger of the two at the card's peaks
(`roofline.least_seconds`): the multiply-adds, by ~36x."""

from zkbench import program_spans, roofline
from zkbench.metrics import load

DEVICE = load("ceremony.g1_device_s")

COUNTER = "p2.rescaled_points"
DOUBLINGS = 124
DOUBLING_PRODUCTS = 7
POINT_BYTES = 196


def least(kind: str, points: int) -> float | None:
    """Least seconds to multiply `points` points each by a full-size scalar."""
    imad = points * DOUBLINGS * DOUBLING_PRODUCTS * roofline.FQ_PRODUCT_IMAD
    return roofline.least_seconds(kind, 2 * POINT_BYTES * points, imad)


def rescaled(snap) -> int:
    return sum(k for (_, name, _), k in snap.counts.items() if name == COUNTER)


def read(rec):
    dev = DEVICE.seconds(rec)
    snap = program_spans.snapshot()
    if dev <= 0 or snap is None:
        return None
    n = rescaled(snap)
    t = least(rec["kind"], n) if n else None
    return None if t is None else 100.0 * t / dev
