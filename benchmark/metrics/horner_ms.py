"""horner_ms: the mean ``msm: horner (host)`` span of the traced loop's
calls, in ms: the window sums' Horner in host big integers."""

UNIT, SOURCE = "ms", "program_span"
LAYER, MOVES = "host tail", "msm_points_per_s"


def read(run):
    xs = run.spans.get("msm: horner (host)", [])
    if run.family != "msm" or not xs:
        return None
    return sum(xs) / len(xs) * 1e3
