"""msm_kernel_ms: device time of every kernel in the traced window over
the MSM calls done in it (each counted for its share inside), in ms."""

from benchmark.core import devtrace

UNIT, SOURCE = "ms", "device_trace"
LAYER, MOVES = "MSM window sums", "msm_points_per_s"


def read(run):
    s = devtrace.per_call_s(run, "msm")
    return None if s is None else s * 1e3
