"""wait_cpu_share.msm: of the window MSM calls' ``msm: copy back wait``
spans, the sum of the thread CPU time over the sum of the wall time, in %,
at most 100: near 100 the callers spin while they wait on the card, near 0
they sleep.  A ratio of sums: the thread CPU clock may advance in ticks of
10 ms."""

from benchmark.core import records

UNIT, SOURCE = "%", "program_counter"
LAYER, MOVES = "device wait", "msm_points_per_s"


def read(run):
    return records.cpu_share(run, "msm: copy back wait")
