"""msm_points_per_s: the points of all MSM calls done in the window over
its seconds; a call that straddles an edge counts for its share inside."""

from benchmark.core import stats

UNIT, SOURCE = "points/s", "host_clock"


def read(run):
    if run.family != "msm":
        return None
    return stats.window_work(run.ok_calls, run.w0, run.w1) / (run.w1 - run.w0)
