"""scalar_words_ms.msm: the program's span ``msm: scalar words (host)``, a
window MSM call, in ms: the host transpose of the scalar bytes into (8, n)
words (``PandaManager.ingest_scalars``, ``mont.bytes_to_words``)."""

from benchmark.core import records

UNIT, SOURCE = "ms", "program_span"
LAYER, MOVES = "byte API", "msm_points_per_s"


def read(run):
    return records.per_call_ms(run, "msm: scalar words (host)")
