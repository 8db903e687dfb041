"""msm_call_p95_ms: the 95th percentile of the host wall time (call to
return) of every MSM call issued while the window was open, those that end
after it and those that failed included: the whole call as its caller
sees it, from the byte API down to the card and back.  The closed loop
keeps the session saturated, so the tail swings with the host's pace: it
stands beside the rate as a per-layer reading, with no bound."""

import sys

from benchmark.core import stats

UNIT, SOURCE = "ms", "host_clock"
LAYER, MOVES = "whole call", "msm_points_per_s"


def read(run):
    if run.family != "msm":
        return None
    calls = stats.started_in(run.calls, run.w0, run.w1)
    if len(calls) < 2:
        return None
    print(f"[msm_call_p95_ms] over {len(calls)} calls", file=sys.stderr)
    return stats.p95((c.t1 - c.t0) * 1e3 for c in calls)
