"""horner_offcpu_ms: the spans ``msm: horner (host)`` of the window MSM
calls, their wall time less the thread's CPU time in them, summed and
then over the calls, in ms: Horner is pure Python, so this is the time it
waits for the interpreter lock or a core.  Sums, not a span's own
difference: the thread CPU clock may advance in ticks of 10 ms."""

from benchmark.core import records

UNIT, SOURCE = "ms", "program_counter"
LAYER, MOVES = "host tail", "msm_points_per_s"


def read(run):
    return records.offcpu_ms(run, "msm: horner (host)")
