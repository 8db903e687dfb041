"""Reading torch.profiler's trace of the window (CPU and CUDA activity).

The harness marks the window's open and close with two empty
``record_function`` ranges on its main thread; every device record (kernel,
copy, set) is placed on the window's clock from them.  Busy time is the
union of the device records inside the window; the idle gaps are the
stretches between, each named by the device operation before it and by
what the callers were doing at its middle: in which of the program's spans,
in a call outside them, or between calls (the profiler records the torch
operations of the thread that started it only, so the harness's own
records of calls and spans say what the callers did).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

from . import stats

OPEN, CLOSE = "benchmark: window open", "benchmark: window close"
TOP = 10


def mark(label: str) -> None:
    from torch.profiler import record_function
    with record_function(label):
        pass


def kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "set"
    return "kernel"


@dataclass
class DeviceTrace:
    """Device records as (start s, end s, name, kind) on the window's clock
    (0 at its open), the window's length, busy seconds, and the breakdown."""
    ops: list
    window_s: float
    busy_s: float
    breakdown: dict = field(default_factory=dict)

    def seconds(self, kinds=("kernel",)) -> float:
        """Device seconds of records of ``kinds`` whose middle lies in the
        window."""
        return sum(b - a for a, b, _, k in self.ops
                   if k in kinds and 0 <= (a + b) / 2 < self.window_s)


def host_activity(calls, spans, w0: float) -> list:
    """The callers' calls and the program's spans as (thread, start, end,
    label) on the window's clock; a call is labelled ``None``."""
    return [(c.thread, c.t0 - w0, c.t1 - w0, None) for c in calls] + \
        [(t, a - w0, b - w0, label) for t, a, b, label in spans]


def collect(prof, host: list) -> DeviceTrace:
    """The device records of the profiled window, its busy time and its
    breakdown; ``host`` as :func:`host_activity` gives it."""
    from torch.autograd import DeviceType
    events = prof.events()
    marks = {e.name: e.time_range.start for e in events
             if e.name in (OPEN, CLOSE)}
    if set(marks) != {OPEN, CLOSE}:
        raise RuntimeError("the profiler lost the window's marks")
    w0, w1 = marks[OPEN], marks[CLOSE]
    window = (w1 - w0) / 1e6
    ops = []
    for e in events:
        a, b = (e.time_range.start - w0) / 1e6, (e.time_range.end - w0) / 1e6
        if e.device_type == DeviceType.CUDA and b > 0 and a < window \
                and "Activity Buffer" not in e.name:
            ops.append((a, b, e.name, kind(e.name)))
    ivs = [(a, b) for a, b, _, _ in ops]
    return DeviceTrace(ops, window, stats.busy(ivs, 0.0, window),
                       breakdown(ops, host, window))


def _short(name: str, size: int = 60) -> str:
    return name if len(name) <= size else name[:size - 3] + "..."


def doing(host: list, t: float) -> str:
    """What each caller was doing at time t: the innermost of the program's
    spans open on its thread, a call outside them, or nothing."""
    threads = {th for th, _, _, label in host if label is None}
    what = collections.Counter()
    for th in threads:
        spans = [(b - a, label) for t_, a, b, label in host
                 if t_ == th and label is not None and a <= t <= b]
        in_call = any(t_ == th and label is None and a <= t <= b
                      for t_, a, b, label in host)
        what[min(spans)[1] if spans else
             "in a call, no span" if in_call else "between calls"] += 1
    return ", ".join(f"{k} x{v}" for k, v in sorted(what.items()))


def breakdown(ops: list, host: list, window: float) -> dict:
    """The device operations that took most time (seconds summed by name)
    and the longest idle gaps, named by what preceded them on the device
    and what the callers were doing in them."""
    by_name = collections.Counter()
    for a, b, name, _ in ops:
        if 0 <= (a + b) / 2 < window:
            by_name[_short(name)] += b - a
    ends = sorted((b, name) for a, b, name, _ in ops)
    out_gaps = []
    for g0, g1 in stats.gaps([(a, b) for a, b, _, _ in ops], 0.0,
                             window)[:TOP]:
        before = [name for b, name in ends if b <= g0 + 1e-9]
        label = (f"after {_short(before[-1], 40) if before else 'open'}; "
                 f"callers: {doing(host, (g0 + g1) / 2) or 'none'}")
        out_gaps.append([_short(label, 160), g1 - g0])
    return {"device_ops": [[n, s] for n, s in by_name.most_common(TOP)],
            "idle_gaps": out_gaps}


def per_call_s(run, family: str, kinds=("kernel",)):
    """Device seconds of records of ``kinds`` in the traced window over the
    calls of ``family`` done in it (each counted for its share inside), or
    None when the run has no such calls or records."""
    if run.family != family or run.device is None:
        return None
    calls = stats.window_calls(run.ok_calls, run.w0, run.w1)
    seconds = run.device.seconds(kinds)
    if calls <= 0 or seconds <= 0:
        return None
    return seconds / calls
