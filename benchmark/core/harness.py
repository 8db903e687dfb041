"""One run of one cell: set-up, the closed loop's window, the check against
the reference, and the metrics.

``run`` is the whole run but the look for the card (``benchmark/run.py``
does that), so the tests drive it on the CPU with the program's plain
versions at small sizes.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from . import devtrace, hostinfo, loop, spec, stats

FORBIDDEN = ("jax", "jaxlib", "flax", "panda_tpu")


@dataclass
class Context:
    """What a driver is given: the cell's configuration and mix, the seed,
    the device and the size."""
    config: dict
    mix: dict
    seed: int
    device: str
    log_n: int


@dataclass
class Run:
    """What the metrics read."""
    cell: str
    family: str
    config: dict
    log_n: int
    calls: list
    w0: float
    w1: float
    setup_s: float
    spans: dict = field(default_factory=dict)
    device: devtrace.DeviceTrace | None = None

    @property
    def ok_calls(self) -> list:
        return [c for c in self.calls if c.error is None]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must never
    load (compared whole: ``panda_tpu_torch`` is not ``panda_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _spans_since(mark: dict) -> dict:
    from panda_tpu_torch.utils import trace
    return {label: list(xs[mark.get(label, 0):])
            for label, xs in list(trace.phase_times.items())}


def _span_mark() -> dict:
    from panda_tpu_torch.utils import trace
    return {label: len(xs) for label, xs in list(trace.phase_times.items())}


@contextlib.contextmanager
def span_clock(out: list):
    """While open, each span the program records is also kept with its
    end on the host clock and its thread, (thread, start, end, label): the
    program's spans carry only their lengths."""
    from panda_tpu_torch.utils import trace
    record = trace._record

    def timed(label, dt):
        record(label, dt)
        end = time.perf_counter()
        out.append((threading.get_ident(), end - dt, end, label))
    trace._record = timed
    try:
        yield
    finally:
        trace._record = record


def check(calls: list, answer_of, expected: dict) -> dict:
    """Each call's answer (``answer_of(call)``) against the reference's for
    its key: ``wrong`` the calls whose answer differs, ``failed`` the calls
    that raised, ``checked`` the calls compared."""
    wrong = failed = checked = 0
    for c in calls:
        if c.error is not None:
            failed += 1
            continue
        checked += 1
        if answer_of(c) != expected[c.key]:
            wrong += 1
    return {"wrong": wrong, "failed": failed, "checked": checked}


def verdict(counts: dict) -> tuple:
    """(correct, the numbers compared with their limits)."""
    checks = {"wrong": {"value": counts["wrong"], "limit": 0, "ok_if": "<="},
              "failed": {"value": counts["failed"], "limit": 0,
                         "ok_if": "<="},
              "checked": {"value": counts["checked"], "limit": 1,
                          "ok_if": ">="}}
    ok = all(v["value"] <= v["limit"] if v["ok_if"] == "<="
             else v["value"] >= v["limit"] for v in checks.values())
    return ok, checks


def _device_info(device: str) -> dict:
    import torch
    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run(name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", root: Path = spec.ROOT,
        t_start: float | None = None, log_n: int | None = None,
        mix: dict | None = None, control: bool = False) -> dict:
    """One run of cell ``name``; returns the result line's object.  The
    size defaults to the configuration's and the mix to the cell's (``mix``
    overrides some of its keys: the tests' small runs on the CPU);
    ``control`` also judges the control's answers in the program's place
    (``control`` in the result)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.cell(name, root)
    cfg = cell.config
    ctx = Context(cfg, {**cell.mix, **(mix or {})}, seed, device,
                  log_n if log_n is not None else cfg["log_n"])
    t_imported = time.perf_counter()
    drv = cell.driver.Driver(ctx)
    t_built = time.perf_counter()
    drv.warm()
    log(f"[{name}] set-up: to the harness {t_imported - t_start:.3f} s, "
        f"inputs and session {t_built - t_imported:.3f} s, warm-up "
        f"{time.perf_counter() - t_built:.3f} s")

    prof = None
    if trace:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        drv.call(drv.keys[0])          # a throwaway step opens the trace
        if device.startswith("cuda"):
            torch.cuda.synchronize()
    spans0, timed_spans, host = _span_mark(), [], []

    def edge(label):
        if trace:
            devtrace.mark(label)
        host.append(hostinfo.snapshot())
    try:
        with (span_clock(timed_spans) if trace else contextlib.nullcontext()):
            calls, answers, w0, w1 = loop.closed_loop(
                drv.callers, drv.job, drv.call, seconds,
                on_open=lambda: edge(devtrace.OPEN),
                on_close=lambda: edge(devtrace.CLOSE))
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    spans = _spans_since(spans0)
    dev = _device_info(device)
    setup_s = w0 - t_start
    result = Run(name, cell.driver.FAMILY, cfg, ctx.log_n, calls, w0, w1, setup_s, spans,
                 devtrace.collect(prof, devtrace.host_activity(
                     calls, timed_spans, w0)) if trace else None)
    log(f"[{name}] window {w1 - w0:.3f} s, {len(calls)} calls "
        f"({sum(1 for c in calls if w0 <= c.t0 < w1)} issued in it), "
        f"set-up {setup_s:.3f} s")
    q = (w1 - w0) / 4
    log(f"[{name}] work a second by quarter of the window: " + ", ".join(
        f"{stats.window_work(result.ok_calls, w0 + i * q, w0 + (i + 1) * q) / q:.6g}"
        for i in range(4)) + "; calls by caller: " + ", ".join(
        str(sum(1 for c in calls if c.caller == i))
        for i in range(drv.callers)))
    log(f"[{name}] host: {hostinfo.settings()}")
    done = stats.window_calls(result.ok_calls, w0, w1)
    log(f"[{name}] host over the window: "
        f"{hostinfo.report(host[0], host[1], w1 - w0, done)}")

    drv.release()                         # free the program's state
    gc.collect()
    if device.startswith("cuda"):
        import torch
        torch.cuda.empty_cache()
    used = sorted({c.key for c in calls})
    t_ref = time.perf_counter()
    expected = {k: loop.digest(v) for k, v in drv.expected(used).items()}
    counts = check(calls, lambda c: answers.by_key[c.key][c.answer],
                   expected)
    log(f"[{name}] reference {time.perf_counter() - t_ref:.3f} s for "
        f"{len(used)} keys")
    correct, checks = verdict(counts)
    out = {"correct": correct, "attempted": len(calls),
           "failed": counts["failed"] + counts["wrong"]}

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(result)
        if value is None:
            if correct and not trace:
                raise RuntimeError(f"end-to-end metric {m.name} read nothing")
            continue
        metrics[m.name] = {"value": value, "unit": m.unit}
    out["metrics"] = metrics
    if trace:
        dev["busy_s"] = result.device.busy_s
        dev["window_s"] = result.device.window_s
    out["device"] = dev
    if trace:
        out["breakdown"] = result.device.breakdown
    if control:                 # the control's answers in the program's
        ctl = {k: loop.digest(v)   # place, for every call of the window
               for k, v in drv.control(used).items()}
        ctl_ok, ctl_checks = verdict(check(calls, lambda c: ctl[c.key],
                                           expected))
        out["control"] = {"correct": ctl_ok, "checks": ctl_checks}
    out["checks"] = checks
    return out
