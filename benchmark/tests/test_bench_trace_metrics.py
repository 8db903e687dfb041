"""The per-layer metrics that read the program's span records
(``panda_tpu_torch.utils.trace.records()``): traced runs of each cell on
the CPU at a small size, a ring that dropped records of the window, and
the readers' arithmetic on synthetic records."""

import collections

import pytest

from benchmark.core import devtrace, harness, spec, stats
from benchmark.core.harness import Run
from panda_tpu_torch.utils import trace

SMALL = {"log_n": 3, "mix": {"callers": 2}}
SECONDS = 4.0          # a traced call on the CPU takes about 2 s
RECORDS = ("scalar_words_ms.msm", "scalar_copy_in_ms.msm", "launch_ms.msm",
           "copy_back_wait_ms.msm", "wait_cpu_share.msm", "horner_offcpu_ms",
           "host_cpu_ms.msm")
NEW = RECORDS + ("idle_in_launch_share.msm",)
CELLS = {"bls12-377-zprize-2p24.batch4": RECORDS,
         "bn254-groth16-2p20.witness-msm": RECORDS[2:]}


def reader(name):
    path = spec.ROOT / "benchmark" / "metrics" / f"{name}.py"
    return spec._module(path, "metric").read


def test_the_benchmark_is_sound():
    assert spec.problems(spec.load()) == []


def test_each_new_metric_lists_the_cells_that_read_it():
    listed = {e["name"]: set(e["workloads"])
              for e in spec.load()["per_layer"] if e["name"] in NEW}
    assert set(listed) == set(NEW)
    for name in NEW:
        assert listed[name] == {c for c, names in CELLS.items()
                                if name in names or
                                name == "idle_in_launch_share.msm"}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_records(cell):
    out = harness.run(cell, 2**31 + 17, SECONDS, True, device="cpu", **SMALL)
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    for name in CELLS[cell]:
        assert name in m, name
    # No card: no device record, so the device share reads nothing.
    assert "idle_in_launch_share.msm" not in m
    for name in ("launch_ms.msm", "host_cpu_ms.msm"):
        assert m[name] > 0
    assert 0 <= m["wait_cpu_share.msm"] <= 100
    assert m["horner_offcpu_ms"] >= 0
    assert "byte_api_self_ms.msm" in m and m["horner_ms"] > 0


def test_a_ring_that_dropped_records_of_the_window_reads_nothing(
        monkeypatch):
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=8))
    out = harness.run("bn254-groth16-2p20.witness-msm", 45, SECONDS, True,
                      device="cpu", **SMALL)
    assert out["correct"] is True
    assert trace.dropped() > 0
    assert not set(NEW) & set(out["metrics"])
    assert out["metrics"]["horner_ms"]["value"] > 0


# Synthetic records: an ingest in set-up, two calls in the window [10 s,
# 11 s], one ending after it.  (id, parent, call, label, thread, t0 s,
# t1 s, cpu s)
MS = 1e-3
SPANS = [
    (20, None, None, "msm: scalar words (host)", 7, 5.0, 5.1, 100 * MS),
    (2, 1, 1, "msm: scalar words (host)", 7, 9.999, 10.001, 2 * MS),
    (3, 1, 1, "msm: scalar copy in", 7, 10.001, 10.005, 1 * MS),
    (5, 4, 1, "msm: launches (host)", 7, 10.005, 10.007, 2 * MS),
    (6, 4, 1, "msm: copy back wait", 7, 10.007, 10.017, 10 * MS),
    (4, 1, 1, "msm: window sums (device)", 7, 10.005, 10.017, 12 * MS),
    (7, 1, 1, "msm: horner (host)", 7, 10.017, 10.027, 4 * MS),
    (1, None, 1, "msm: call", 7, 9.999, 10.027, 20 * MS),
    (9, 8, 8, "msm: launches (host)", 8, 10.100, 10.104, 4 * MS),
    (10, 8, 8, "msm: copy back wait", 8, 10.104, 10.114, 0),
    (11, 8, 8, "msm: horner (host)", 8, 10.114, 10.120, 6 * MS),
    (8, None, 8, "msm: call", 8, 10.100, 10.120, 10 * MS),
    (13, 12, 12, "msm: launches (host)", 7, 10.900, 10.950, 50 * MS),
    (12, None, 12, "msm: call", 7, 10.900, 11.200, 60 * MS),
]


def synthetic_records(spans):
    ns = 1_000_000_000
    return [trace.Record(i, p, c, label, th, round(a * ns), round(b * ns),
                         round(cpu * ns))
            for i, p, c, label, th, a, b, cpu in spans]


@pytest.fixture
def synthetic(monkeypatch):
    recs = synthetic_records(SPANS)
    monkeypatch.setattr(trace, "records", lambda: list(recs))
    monkeypatch.setattr(trace, "dropped", lambda: 0)
    # Device busy [0, 0.004] and [0.006, 0.5] of a 1 s window from 10 s.
    ops = [(0.0, 0.004, "k", "kernel"), (0.006, 0.5, "k", "kernel")]
    dev = devtrace.DeviceTrace(ops, 1.0, stats.busy(
        [(a, b) for a, b, _, _ in ops], 0.0, 1.0))
    return Run("c", "msm", {}, 3, [], 10.0, 11.0, 1.0, {}, dev)


def test_readers_on_synthetic_records(synthetic):
    read = {name: reader(name)(synthetic) for name in NEW}
    assert read["scalar_words_ms.msm"] == pytest.approx(1.0)   # 2 ms / 2
    assert read["scalar_copy_in_ms.msm"] == pytest.approx(2.0)
    assert read["launch_ms.msm"] == pytest.approx(3.0)         # (2 + 4) / 2
    assert read["copy_back_wait_ms.msm"] == pytest.approx(10.0)
    assert read["wait_cpu_share.msm"] == pytest.approx(50.0)   # 10 of 20
    assert read["horner_offcpu_ms"] == pytest.approx(3.0)      # (6 + 0) / 2
    assert read["host_cpu_ms.msm"] == pytest.approx(15.0)
    # Idle: [0.004, 0.006] (the first call's launches cover 0.001 s of
    # it) and [0.5, 1.0] (the third call's launches 0.05 s); busy: [0,
    # 0.004] and [0.006, 0.5] (the first call's launches 0.001 s, the
    # second's 0.004 s).
    assert read["idle_in_launch_share.msm"] == pytest.approx(
        (0.051 / 0.502 - 0.005 / 0.498) * 100)


def test_cpu_readers_are_sums_of_ticks(synthetic, monkeypatch):
    """A thread CPU clock that advances in 10 ms ticks: each span reads a
    whole tick or none.  The sums read the CPU time the spans took; a
    clip of each span's CPU to its wall would read 2 ms a call off the
    CPU in Horner, and 60% in the waits, where the sums read 0 and 100%."""
    spans = [s for s in SPANS if s[3] not in ("msm: horner (host)",
                                              "msm: copy back wait")]
    spans += [
        (6, 4, 1, "msm: copy back wait", 7, 10.007, 10.013, 10 * MS),
        (7, 1, 1, "msm: horner (host)", 7, 10.017, 10.023, 10 * MS),
        (10, 8, 8, "msm: copy back wait", 8, 10.104, 10.108, 0),
        (11, 8, 8, "msm: horner (host)", 8, 10.114, 10.118, 0),
    ]
    recs = synthetic_records(spans)
    monkeypatch.setattr(trace, "records", lambda: list(recs))
    assert reader("horner_offcpu_ms")(synthetic) == pytest.approx(0.0)
    assert reader("wait_cpu_share.msm")(synthetic) == pytest.approx(100.0)
    recs[-1] = recs[-1]._replace(t1_ns=recs[-1].t1_ns + 2_000_000)
    assert reader("horner_offcpu_ms")(synthetic) == pytest.approx(1.0)


def test_idle_in_launch_share_is_the_excess_over_chance(synthetic,
                                                       monkeypatch):
    """Launches that cover the whole window read 0, however much of the
    idle time they cover; launches only in the idle time read 100."""
    recs = synthetic_records(SPANS + [
        (30, 12, 12, "msm: launches (host)", 9, 9.5, 11.5, 0)])
    monkeypatch.setattr(trace, "records", lambda: list(recs))
    assert reader("idle_in_launch_share.msm")(synthetic) == pytest.approx(0)
    spans = [s for s in SPANS if s[3] != "msm: launches (host)"]
    recs = synthetic_records(spans + [
        (9, 8, 8, "msm: launches (host)", 8, 10.004, 10.006, 0),
        (13, 12, 12, "msm: launches (host)", 7, 10.5, 11.0, 0)])
    monkeypatch.setattr(trace, "records", lambda: list(recs))
    assert reader("idle_in_launch_share.msm")(synthetic) == pytest.approx(100)


def test_readers_on_synthetic_records_with_drops(synthetic, monkeypatch):
    """Dropped records that ended before every counted call began leave
    the readings as they were; drops that may reach into the window
    silence every reader."""
    monkeypatch.setattr(trace, "dropped", lambda: 3)
    assert reader("launch_ms.msm")(synthetic) == pytest.approx(3.0)
    recs = synthetic_records(SPANS[2:])       # the oldest kept ends at 10.005
    monkeypatch.setattr(trace, "records", lambda: list(recs))
    assert all(reader(name)(synthetic) is None for name in NEW)


def test_readers_read_nothing_without_records(synthetic, monkeypatch):
    """A program without span records (no ``trace.records``), or a run
    with no MSM call in the window: every reader returns None."""
    recs = trace.records()
    monkeypatch.delattr(trace, "records")
    assert all(reader(name)(synthetic) is None for name in NEW)
    monkeypatch.setattr(trace, "records", lambda: list(recs), raising=False)
    assert reader("launch_ms.msm")(synthetic) == pytest.approx(3.0)
    synthetic.w0, synthetic.w1 = 20.0, 21.0
    assert all(reader(name)(synthetic) is None for name in NEW)
