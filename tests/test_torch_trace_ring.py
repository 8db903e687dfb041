"""The span records of the port's trace module
(``panda_tpu_torch/utils/trace.py``) under concurrent MSM calls, in a full
ring, and through the ``_record`` hook; ``tests/test_torch_trace.py``
holds the byte API's labels and one call's records."""

import sys
import threading


from panda_tpu_torch.runtime import api
from panda_tpu_torch.utils import trace
from tests.jax_release import release_jax_programs  # noqa: F401
from tests.test_torch_trace import MSM_SPANS, _session


def test_threads_keep_distinct_call_ids(monkeypatch):
    """Four threads inside their MSM calls at once (held together in the
    Horner tail) keep four call ids, each with its own thread's spans.  The
    window sums are computed once and handed to every call, so the four
    calls cost four Horner tails."""
    gm, scalars = _session(4, 12)
    want = api.msm_bn254_with_cached_bases(gm, scalars, 0)
    fn = api.msm_ops.window_sums_fn(gm.curve, api.msm_ops.window_bits(2))
    sums = fn(*gm.d_bases[0], gm.ingest_scalars(scalars))
    monkeypatch.setattr(api.msm_ops, "window_sums_fn",
                        lambda curve, c: lambda *a: sums)
    meet = threading.Barrier(4, timeout=60)
    horner = api.msm_ops.host_horner

    def held(*a, **k):
        meet.wait()
        return horner(*a, **k)
    monkeypatch.setattr(api.msm_ops, "host_horner", held)
    trace.reset()
    out, errors = [], []

    def caller():
        try:
            out.append(api.msm_bn254_with_cached_bases(gm, scalars, 0))
        except Exception as e:                  # pragma: no cover
            errors.append(e)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors and out == [want] * 4
    recs = trace.records()
    calls = [r for r in recs if r.label == "msm: call"]
    assert len({r.id for r in calls}) == 4
    assert len({r.thread for r in calls}) == 4
    for call in calls:
        mine = [r for r in recs if r.call == call.id]
        assert sorted(r.label for r in mine) == sorted(MSM_SPANS)
        assert {r.thread for r in mine} == {call.thread}
    assert len(recs) == 4 * len(MSM_SPANS)


def test_ring_drops_its_oldest_records_and_counts_them():
    trace.reset()
    extra = 5
    for i in range(trace.RING_SIZE + extra):
        with trace.timer(f"unit: {i}"):
            pass
    recs = trace.records()
    assert len(recs) == trace.RING_SIZE
    assert trace.dropped() == extra
    assert recs[0].label == f"unit: {extra}"
    assert recs[-1].label == f"unit: {trace.RING_SIZE + extra - 1}"
    trace.reset()
    assert trace.records() == [] and trace.dropped() == 0


def test_record_hook_sees_every_span_once(monkeypatch):
    """``_record`` is still called once a span, timer or span alike, so a
    wrapper of it (as the benchmark's clock of spans) sees every label."""
    seen = []
    record = trace._record

    def wrapped(label, dt):
        record(label, dt)
        seen.append((label, dt))
    monkeypatch.setattr(trace, "_record", wrapped)
    trace.reset()
    with trace.timer("unit: call"):
        with trace.timer("unit: inner"):
            pass
        s = trace.span("unit: imperative")
        dt = s.end()
    assert [label for label, _ in seen] == [
        "unit: inner", "unit: imperative", "unit: call"]
    assert seen[1][1] == dt
    recs = trace.records()
    assert [r.label for r in recs] == [label for label, _ in seen]
    call = recs[-1]
    assert call.call == call.id and call.parent is None
    assert all(r.parent == call.id and r.call == call.id for r in recs[:2])
