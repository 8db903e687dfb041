"""msm_roofline_share: the least time the H100 needs for an MSM's work
(``benchmark/core/work.py``: n ceil(bits / 16) mixed additions and the
bucket reduction's 2 (2^16 - 1) additions a window at the reference
library's window rule, each scalar and base read once), over the kernel
time an MSM call (``msm_kernel_ms``), in %."""

from benchmark.core import devtrace, work
from benchmark.reference import curves

UNIT, SOURCE = "%", "device_trace"
LAYER, MOVES = "kernels", "msm_points_per_s"


def read(run):
    s = devtrace.per_call_s(run, "msm")
    if s is None:
        return None
    curve = curves.CURVES[run.config["curve"]]
    return work.msm(run.log_n, curve.fr.bits, curve.fp.n_bytes) / s * 100
