"""byte_api_self_ms.msm: the byte API's own time an MSM call, in ms: the
harness's clock around every call of the traced loop, less the program's
spans ``msm: window sums (device)`` (the launches and the wait of the
sums' copy back) and ``msm: horner (host)`` of the same calls, over the
calls.  What is left is the scalar ingest (bytes to words, the copy to the
card), the checks and the blob.  The spans carry no call id, so sums are
taken, not pairs."""

UNIT, SOURCE = "ms", "program_span"
LAYER, MOVES = "byte API", "msm_points_per_s"
SPANS = ("msm: window sums (device)", "msm: horner (host)")


def read(run):
    if run.family != "msm":
        return None
    calls = run.ok_calls
    spans = [run.spans.get(label, []) for label in SPANS]
    if not calls or any(len(s) != len(calls) for s in spans):
        return None
    wall = sum(c.t1 - c.t0 for c in calls)
    return (wall - sum(map(sum, spans))) / len(calls) * 1e3
