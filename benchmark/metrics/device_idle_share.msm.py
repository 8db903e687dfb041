"""device_idle_share.msm: the share of the traced window in which no
kernel, copy or set ran on the card (1 - the union of the device records
over the window), in % (MSM cells)."""

UNIT, SOURCE = "%", "device_trace"
LAYER, MOVES = "device", "msm_points_per_s"


def read(run):
    if run.family != "msm" or run.device is None or run.device.busy_s <= 0:
        return None
    return (1 - run.device.busy_s / run.device.window_s) * 100
