"""copy_back_wait_ms.msm: the program's span ``msm: copy back wait``, a
window MSM call, in ms: the caller blocked in the window sums' three
``.cpu()`` until the card's one stream reaches its copy, the kernels of
other callers queued ahead of it included."""

from benchmark.core import records

UNIT, SOURCE = "ms", "program_span"
LAYER, MOVES = "device wait", "msm_points_per_s"


def read(run):
    return records.per_call_ms(run, "msm: copy back wait")
