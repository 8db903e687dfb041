"""The port's trace utilities (``panda_tpu_torch/utils/trace.py``), the
twin of ``tests/test_trace.py``; the byte API's phase labels, the JAX
API's five and the MSM call's spans; and one call's span records: ids,
parents, call ids and clocks (``tests/test_torch_trace_ring.py`` holds
the rest)."""

import random
import threading
import time

import pytest
import torch

from panda_tpu_torch import BN254, InitUnitType, PandaManager
from panda_tpu_torch.reference import curve_ref
from panda_tpu_torch.runtime import api
from panda_tpu_torch.utils import trace
from tests.jax_release import release_jax_programs  # noqa: F401


def test_timer_records_and_prints(capsys, monkeypatch):
    monkeypatch.setenv("PANDA_PRINT_TRACE", "1")
    trace.reset()
    with trace.timer("unit: test phase", block=[torch.zeros((4,))]):
        pass
    out = capsys.readouterr().out
    assert "Start: unit: test phase" in out
    assert "End:   unit: test phase" in out
    s = trace.summary()
    assert s["unit: test phase"]["count"] == 1
    assert s["unit: test phase"]["total_s"] >= 0


def test_span_silent_by_default(capsys, monkeypatch):
    monkeypatch.delenv("PANDA_PRINT_TRACE", raising=False)
    trace.reset()
    t = trace.span("quiet phase")
    dt = t.end(block=torch.zeros((4,)))
    assert dt >= 0
    assert capsys.readouterr().out == ""
    assert trace.phase_times["quiet phase"] == [dt]


def test_api_records_phases(monkeypatch):
    """The byte API records the JAX API's labels, the NTT's three phases
    and the MSM's two, and the MSM call's own five spans."""
    monkeypatch.delenv("PANDA_PRINT_TRACE", raising=False)
    fr, fp = BN254.fr, BN254.fp
    rng = random.Random(3)
    trace.reset()
    gm = PandaManager.init_all(0, InitUnitType.NTT, device="cpu")
    vals = [rng.randrange(fr.modulus) for _ in range(8)]
    data = b"".join(fr.to_wire_int(v).to_bytes(32, "little") for v in vals)
    api.ntt_bn254(gm, data, 3)
    pts = [curve_ref.random_point(BN254, rng) for _ in range(4)]
    bases = b"".join(fp.to_wire_int(v).to_bytes(32, "little")
                     for pt in pts for v in pt)
    api.msm_bn254(gm, data[:4 * 32], bases)
    assert sorted(trace.summary()) == [
        "msm: call", "msm: copy back wait", "msm: horner (host)",
        "msm: launches (host)", "msm: scalar copy in",
        "msm: scalar words (host)", "msm: window sums (device)",
        "ntt: d2h result", "ntt: execute", "ntt: h2d + domain shift"]
    assert all(v["count"] == 1 for v in trace.summary().values())


def test_profile_to_writes_a_trace(tmp_path):
    with trace.profile_to(str(tmp_path)):
        torch.ones(8).sum()
    assert list(tmp_path.glob("*.pt.trace.json"))


# The MSM call's spans: (label, the label of its parent).
MSM_SPANS = {"msm: call": None,
             "msm: scalar words (host)": "msm: call",
             "msm: scalar copy in": "msm: call",
             "msm: window sums (device)": "msm: call",
             "msm: launches (host)": "msm: window sums (device)",
             "msm: copy back wait": "msm: window sums (device)",
             "msm: horner (host)": "msm: call"}
N_CALLS = 2


def _session(n: int, seed: int):
    """A CPU session holding n random BN254 bases, and n scalars' bytes."""
    fr, fp = BN254.fr, BN254.fp
    rng = random.Random(seed)
    pts = [curve_ref.random_point(BN254, rng) for _ in range(n)]
    bases = b"".join(fp.to_wire_int(v).to_bytes(32, "little")
                     for pt in pts for v in pt)
    gm = PandaManager.init_all(0, InitUnitType.MSM, [bases], device="cpu")
    scalars = b"".join(fr.to_wire_int(rng.randrange(fr.modulus))
                       .to_bytes(32, "little") for _ in range(n))
    return gm, scalars


@pytest.fixture(scope="module")
def msm_calls():
    """N_CALLS MSM calls through the cached-bases alias at n = 8: each
    call's perf_counter_ns bracket, and the records and phase counts they
    left."""
    gm, scalars = _session(8, 11)
    trace.reset()
    brackets = []
    for _ in range(N_CALLS):
        t0 = time.perf_counter_ns()
        api.msm_bn254_with_cached_bases(gm, scalars, 0)
        brackets.append((t0, time.perf_counter_ns()))
    return brackets, trace.records(), trace.summary()


def test_msm_call_records_share_its_call_id(msm_calls):
    """One ``msm: call`` record a call; every other record of the call
    carries its id as the call id, and the parent its label names."""
    _, recs, _ = msm_calls
    calls = [r for r in recs if r.label == "msm: call"]
    assert len(calls) == N_CALLS and len(recs) == N_CALLS * len(MSM_SPANS)
    by_id = {r.id: r for r in recs}
    assert len(by_id) == len(recs)
    for call in calls:
        mine = [r for r in recs if r.call == call.id]
        assert sorted(r.label for r in mine) == sorted(MSM_SPANS)
        for r in mine:
            parent = MSM_SPANS[r.label]
            if parent is None:
                assert r.parent is None and r.id == r.call
            else:
                assert by_id[r.parent].label == parent
                assert by_id[r.parent].call == call.id
            assert r.thread == threading.get_ident()


def _thread_clock_step_ns() -> int:
    """The least step of ``time.thread_time_ns()`` seen over three steps:
    the clock's resolution (a few hundred ns on most hosts; 10 ms where
    the kernel accounts a thread's CPU time in scheduler ticks)."""
    steps = []
    last = time.thread_time_ns()
    stop = time.perf_counter() + 1.0
    while len(steps) < 3 and time.perf_counter() < stop:
        now = time.thread_time_ns()
        if now != last:
            steps.append(now - last)
            last = now
    return min(steps, default=1_000_000_000)


def test_records_lie_in_the_callers_bracket(msm_calls):
    """Each record lies inside its call's own perf_counter_ns bracket and
    inside its parent, and its thread CPU time is no more than its wall
    time, give or take the thread clock's resolution (at least 1 ms): a
    clock that counts in ticks puts a whole tick on the span it lands
    in."""
    brackets, recs, _ = msm_calls
    grain = max(1_000_000, _thread_clock_step_ns())
    calls = sorted((r for r in recs if r.label == "msm: call"),
                   key=lambda r: r.t0_ns)
    by_id = {r.id: r for r in recs}
    for (b0, b1), call in zip(brackets, calls):
        for r in (r for r in recs if r.call == call.id):
            assert b0 <= r.t0_ns <= r.t1_ns <= b1
            assert 0 <= r.cpu_ns <= r.t1_ns - r.t0_ns + grain
            if r.parent is not None:
                p = by_id[r.parent]
                assert p.t0_ns <= r.t0_ns <= r.t1_ns <= p.t1_ns


def test_existing_msm_labels_recorded_once_a_call(msm_calls):
    _, _, summary = msm_calls
    for label in MSM_SPANS:
        assert summary[label]["count"] == N_CALLS, label
