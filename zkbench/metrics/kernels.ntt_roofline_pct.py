"""The NTT kernel's share of its roofline, in percent: the least time of
every `ops.ntt.ntt_axis` call in the traced window (`roofline.ntt_least`)
over the device seconds of the kernel `ops.ntt_device_s` names."""

from zkbench import roofline
from zkbench.metrics import load

DEVICE = load("ops.ntt_device_s")


def read(rec):
    dev = DEVICE.seconds(rec)
    if dev <= 0 or not rec["ntt"]:
        return None
    least = 0.0
    for n, batch in rec["ntt"]:
        t = roofline.least_seconds(rec["kind"], *roofline.ntt_least(n, batch))
        if t is None:
            return None
        least += t
    return 100.0 * least / dev
