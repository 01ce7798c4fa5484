"""B13's share of its roofline in the close of phase 1, in percent: the least
time the job's full-size scalar multiplications need, over the device
seconds B13's kernels took in the traced window
(`ceremony.prepare_g1_device_s`).

The least work is `kernels.g1_roofline_pct`'s `least()` (124 doublings a
lane, IMAD-bound) over the lanes of the program's counters
`prep.full_scalar_lanes` (the prepare's multiplications by a power of y, an
L_i(y), a user-vector entry, a twiddle or 1/size), `p1.multiplied_points`
(the contribution's powers) and `p1.checked_points` (the checked load's
r P): each a lane multiplied by a scalar drawn from all of Fr.  The R1CS
coefficients' products, which may be small, the group NTT's butterfly adds
and the sums per wire are not counted, so a redesign cannot read over 100%."""

from zkbench import program_spans
from zkbench.metrics import load

DEVICE = load("ceremony.g1_device_s")
ROOF = load("kernels.g1_roofline_pct")

COUNTERS = ("prep.full_scalar_lanes", "p1.multiplied_points", "p1.checked_points")


def lanes(snap) -> int:
    return sum(k for (_, name, _), k in snap.counts.items() if name in COUNTERS)


def read(rec):
    dev = DEVICE.seconds(rec)
    snap = program_spans.snapshot()
    if dev <= 0 or snap is None:
        return None
    n = lanes(snap)
    t = ROOF.least(rec["kind"], n) if n else None
    return None if t is None else 100.0 * t / dev
