"""The program's span records (``panda_tpu_torch.utils.trace.records()``)
of a run's MSM calls: those whose ``msm: call`` record ends in the window
[``run.w0``, ``run.w1``] (both on the clock of ``time.perf_counter``).

Each reader returns None where the program keeps no records, where the
ring may have dropped a record of the window, or where no call qualifies.
"""

from __future__ import annotations

CALL = "msm: call"


def _read(run) -> tuple | None:
    """(every record of the ring, {call id: its records, the ``msm: call``
    record among them} of the MSM calls that end in the window)."""
    if run.family != "msm":
        return None
    from panda_tpu_torch.utils import trace
    if not hasattr(trace, "records"):
        return None
    recs = trace.records()
    calls = {r.id: [] for r in recs
             if r.label == CALL and run.w0 <= r.t1_ns / 1e9 <= run.w1}
    if not calls:
        return None
    if trace.dropped():
        # The ring lets go of its oldest records, those that ended first.
        start = min(run.w0, *(r.t0_ns / 1e9 for r in recs if r.id in calls))
        if recs[0].t1_ns / 1e9 >= start:
            return None
    for r in recs:
        if r.call in calls:
            calls[r.call].append(r)
    return recs, calls


def _labelled(run, label: str) -> tuple | None:
    """(the number of window calls, their ``label`` records)."""
    read = _read(run)
    if read is None:
        return None
    calls = read[1]
    return len(calls), [r for rs in calls.values() for r in rs
                        if r.label == label]


def wall_ns(r) -> int:
    return r.t1_ns - r.t0_ns


def per_call_ms(run, label: str, value=wall_ns) -> float | None:
    """The sum of ``value`` (ns) over the window calls' ``label`` records,
    over the number of calls, in ms; None where no call has one."""
    got = _labelled(run, label)
    if got is None or not got[1]:
        return None
    n, rs = got
    return sum(map(value, rs)) / n / 1e6


def cpu_share(run, label: str) -> float | None:
    """The window calls' ``label`` records: the sum of their thread CPU
    over the sum of their wall time, in %, at most 100.  A ratio of sums:
    a thread CPU clock that advances in ticks (10 ms on some hosts) puts a
    whole tick on the span it lands in and none on the rest, which sums
    leave unbiased and a clip of each span's CPU to its wall does not."""
    got = _labelled(run, label)
    wall = 0 if got is None else sum(map(wall_ns, got[1]))
    if wall <= 0:
        return None
    return min(100.0, sum(r.cpu_ns for r in got[1]) / wall * 100)


def offcpu_ms(run, label: str) -> float | None:
    """The window calls' ``label`` records: the sum of their wall time
    less the sum of their thread CPU, at least 0, over the number of
    calls, in ms (a difference of sums, as ``cpu_share``)."""
    got = _labelled(run, label)
    if got is None or not got[1]:
        return None
    n, rs = got
    return max(0, sum(map(wall_ns, rs)) - sum(r.cpu_ns for r in rs)) / n / 1e6


def intervals(run, label: str) -> list | None:
    """Every ``label`` record of the ring, any call's, as (start, end) on
    the window's clock (seconds from ``run.w0``)."""
    read = _read(run)
    if read is None:
        return None
    return [(r.t0_ns / 1e9 - run.w0, r.t1_ns / 1e9 - run.w0)
            for r in read[0] if r.label == label]
