"""The MSM kernels' share of their roofline, in percent: the least time of
every `ops.msm.msm_start` call in the traced window (`roofline.msm_least`)
over the device seconds of the kernels `ops.msm_device_s` names."""

from zkbench import roofline
from zkbench.metrics import load

DEVICE = load("ops.msm_device_s")


def read(rec):
    dev = DEVICE.seconds(rec)
    if dev <= 0 or not rec["msm"]:
        return None
    least = 0.0
    for points, live in rec["msm"]:
        t = roofline.least_seconds(rec["kind"], *roofline.msm_least(points, live))
        if t is None:
            return None
        least += t
    return 100.0 * least / dev
