"""The metric arithmetic on synthetic calls, spans and device records."""

import statistics

import pytest

from benchmark.core import devtrace, hostinfo, spec, stats, work
from benchmark.core.harness import Run
from benchmark.core.loop import Call
from benchmark.reference import curves


def reader(name):
    """The metric's reader from its file, whether or not a cell uses it."""
    path = spec.ROOT / "benchmark" / "metrics" / f"{name}.py"
    return spec._module(path, "metric").read


def call(t0, t1, work=100, error=None, caller=0):
    return Call(caller, 0, "h/0", work, t0, t1, answer=0, error=error)


def test_window_share_counts_the_part_inside():
    assert stats.window_share(0.0, 2.0, 1.0, 5.0) == 0.5
    assert stats.window_share(4.0, 6.0, 1.0, 5.0) == 0.5
    assert stats.window_share(2.0, 3.0, 1.0, 5.0) == 1.0
    assert stats.window_share(5.0, 6.0, 1.0, 5.0) == 0.0
    calls = [call(0.0, 2.0), call(2.0, 3.0), call(4.0, 6.0), call(6.0, 7.0)]
    assert stats.window_work(calls, 1.0, 5.0) == pytest.approx(200.0)
    assert stats.window_calls(calls, 1.0, 5.0) == pytest.approx(2.0)


def test_rate_is_all_work_over_all_window():
    calls = [call(1.0 + 0.5 * i, 1.5 + 0.5 * i, work=1 << 20)
             for i in range(8)] + [call(4.8, 5.2, work=1 << 20)]
    run = Run("c", "msm", {"curve": "bn254"}, 20, calls, 1.0, 5.0, 3.0)
    m = reader("msm_points_per_s")
    # 8 whole calls and half of the last in 4 s.
    assert m(run) == pytest.approx(8.5 * (1 << 20) / 4.0)
    run.family = "other"            # a cell of another family's driver
    assert m(run) is None


def test_p95_is_over_every_call_issued_in_the_window():
    ms = [10.0 * (i + 1) for i in range(40)]
    calls = [call(1.0 + 0.01 * i, 1.0 + 0.01 * i + x / 1e3)
             for i, x in enumerate(ms)]
    # One call issued before the window (left out) and one failed call
    # issued in it (kept: a failure misses any latency limit).
    calls.append(call(0.5, 0.5 + 5.0))
    calls.append(call(2.0, 2.9, error="RuntimeError: x"))
    run = Run("c", "msm", {}, 20, calls, 1.0, 3.0, 1.0)
    m = reader("msm_call_p95_ms")
    want = statistics.quantiles(ms + [900.0], n=20, method="inclusive")[18]
    assert m(run) == pytest.approx(want)


def test_union_busy_and_gaps():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert stats.union(ivs) == [(0.0, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert stats.busy(ivs, 1.0, 10.0) == pytest.approx(1.0 + 1.0 + 1.0)
    assert stats.gaps(ivs, 1.0, 10.0) == [(4.0, 9.0), (2.0, 3.0)]


def synthetic_trace(kernel_ms, copy_ms, window_s=1.0, calls=10):
    ops = []
    for i in range(calls):
        t = i * window_s / calls
        ops.append((t, t + kernel_ms / 1e3, "phase_a_kernel", "kernel"))
        ops.append((t + kernel_ms / 1e3, t + (kernel_ms + copy_ms) / 1e3,
                    "Memcpy HtoD (Pageable -> Device)", "copy"))
    busy = stats.busy([(a, b) for a, b, _, _ in ops], 0.0, window_s)
    return devtrace.DeviceTrace(ops, window_s, busy,
                                devtrace.breakdown(ops, [], window_s))


def test_device_metrics_on_a_synthetic_trace():
    calls = [call(0.1 * i, 0.1 * i + 0.1, work=1 << 20) for i in range(10)]
    run = Run("c", "msm", {"curve": "bn254"}, 20, calls, 0.0, 1.0, 1.0,
              device=synthetic_trace(20.0, 5.0))
    read = {n: reader(n) for n in (
        "msm_kernel_ms", "msm_roofline_share", "device_idle_share.msm")}
    assert read["msm_kernel_ms"](run) == pytest.approx(20.0)
    assert read["device_idle_share.msm"](run) == pytest.approx(75.0)
    want = work.msm(20, 254, 32) / 0.020 * 100
    assert read["msm_roofline_share"](run) == pytest.approx(want)
    bd = run.device.breakdown
    assert bd["device_ops"][0][0] == "phase_a_kernel"
    assert bd["device_ops"][0][1] == pytest.approx(0.2)
    assert len(bd["idle_gaps"]) == 10
    assert bd["idle_gaps"][0][1] == pytest.approx(0.075)


def test_byte_api_self_time_and_horner_from_spans():
    calls = [call(0.0, 0.060), call(0.0, 0.080)]
    spans = {"msm: window sums (device)": [0.020, 0.030],
             "msm: horner (host)": [0.008, 0.010]}
    run = Run("c", "msm", {}, 20, calls, 0.0, 1.0, 1.0, spans)
    self_ms = reader("byte_api_self_ms.msm")
    horner = reader("horner_ms")
    assert self_ms(run) == pytest.approx((0.140 - 0.068) / 2 * 1e3)
    assert horner(run) == pytest.approx(9.0)
    run.spans["msm: horner (host)"].append(0.01)     # spans of another call
    assert self_ms(run) is None


def test_work_counts():
    n, W = 1 << 20, 16                         # c = 16, ceil(254 / 16)
    imads = 264 * (n * W * 11 + W * 2 * 65535 * 12)
    assert work.msm(20, 254, 32) == pytest.approx(imads / work.IMAD_PER_S)
    # BLS12-377: 253-bit scalars, 12-word base field.
    imads = 588 * ((1 << 24) * 16 * 11 + 16 * 2 * 65535 * 12)
    assert work.msm(24, curves.BLS12_377.fr.bits, 48) == pytest.approx(
        imads / work.IMAD_PER_S)
    # Phase A's share: PERF.md's 2.9126 ms bound of a 2^20 BN254 call.
    assert 264 * n * W * 11 / work.IMAD_PER_S * 1e3 == pytest.approx(
        2.9126, abs=1e-3)
    assert [work.window_bits(k) for k in (12, 13, 15, 19, 20, 26)] == \
        [12, 14, 15, 15, 16, 16]


def test_host_report_reads_what_the_process_did():
    """The run's log line of the host over the window: the process's CPU
    time, a call's share of it and its busiest threads."""
    a = hostinfo.snapshot()
    sum(i * i for i in range(200000))
    b = hostinfo.snapshot()
    line = hostinfo.report(a, b, 1.0, 4)
    assert "process" in line and "cores" in line
    assert "ms a call" in line and ("MainThread" in line
                                    or "busiest" not in line)
    assert "cpus allowed" in hostinfo.settings()
