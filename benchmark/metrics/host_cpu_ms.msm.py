"""host_cpu_ms.msm: the calling thread's CPU time in the span ``msm:
call``, a window MSM call, in ms: the whole call's host work, spin-waits
included."""

from benchmark.core import records

UNIT, SOURCE = "ms", "program_counter"
LAYER, MOVES = "whole call", "msm_points_per_s"


def read(run):
    return records.per_call_ms(run, "msm: call", lambda r: r.cpu_ns)
