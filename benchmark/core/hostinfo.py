"""What the host did over the window, for the run's log: the process's CPU
time, a call's share of it, and its busiest threads, with the CPUs it may
use and their clock.  Read from the process and /proc, never set; a
reading that is not there is left out."""

from __future__ import annotations

import os
import threading
from pathlib import Path

TICK = os.sysconf("SC_CLK_TCK")


def _read(path: str) -> str:
    try:
        return Path(path).read_text()
    except OSError:
        return ""


def _threads() -> dict:
    """Each thread of this process: (its name, Python's where it has one,
    user + system ticks)."""
    named = {str(t.native_id): t.name for t in threading.enumerate()}
    out = {}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        stat = _read(f"/proc/self/task/{tid}/stat")
        if ")" not in stat:
            continue
        name = named.get(tid) or stat[stat.index("(") + 1:stat.rindex(")")]
        f = stat[stat.rindex(")") + 2:].split()
        out[tid] = (name, int(f[11]) + int(f[12]))
    return out


def snapshot() -> dict:
    t = os.times()
    return {"threads": _threads(), "user_s": t.user, "sys_s": t.system}


def settings() -> str:
    mhz = [float(line.split(":")[1]) for line in
           _read("/proc/cpuinfo").splitlines() if line.startswith("cpu MHz")]
    clock = (f"cpu MHz {min(mhz):.0f}-{max(mhz):.0f}" if mhz
             else "cpu MHz unread")
    return f"{len(os.sched_getaffinity(0))} cpus allowed, {clock}"


def report(a: dict, b: dict, seconds: float, calls: float) -> str:
    """One line of what the process did between snapshots ``a`` and ``b``,
    ``seconds`` and ``calls`` apart."""
    user, sys_ = b["user_s"] - a["user_s"], b["sys_s"] - a["sys_s"]
    cpu = user + sys_
    line = (f"process {cpu:.2f} cpu s ({cpu / seconds:.2f} cores, "
            f"{1e3 * cpu / max(calls, 1e-9):.1f} ms a call; user {user:.2f}, "
            f"sys {sys_:.2f})")
    busy = sorted(((ticks - a["threads"].get(tid, (name, 0))[1], name)
                   for tid, (name, ticks) in b["threads"].items()),
                  reverse=True)[:6]
    if busy:
        line += " | busiest threads (cpu s): " + "; ".join(
            f"{name} {t / TICK:.2f}" for t, name in busy)
    return line
