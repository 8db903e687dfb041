"""launch_ms.msm: the program's span ``msm: launches (host)``, a window MSM
call, in ms: the host's time to enqueue the recode, the sort, phase A, the
buckets, padd and wscan (``window_sums_fn``); nothing in it waits for the
card."""

from benchmark.core import records

UNIT, SOURCE = "ms", "program_span"
LAYER, MOVES = "launch glue", "msm_points_per_s"


def read(run):
    return records.per_call_ms(run, "msm: launches (host)")
