"""scalar_copy_in_ms.msm: the program's span ``msm: scalar copy in``, a
window MSM call, in ms: the pageable copy of the scalar words to the card
(``mont.words_tensor``), the wait for the stream to reach it included."""

from benchmark.core import records

UNIT, SOURCE = "ms", "program_span"
LAYER, MOVES = "byte API", "msm_points_per_s"


def read(run):
    return records.per_call_ms(run, "msm: scalar copy in")
