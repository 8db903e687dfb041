"""idle_in_launch_share.msm: how much more of the traced window's device
idle time than of its busy time has at least one caller inside the
program's span ``msm: launches (host)``, in percentage points.

The share alone counts coincidence: where each of four callers spends most
of a call in its launches, some caller is in them nearly all the time, idle
or busy.  The share over the busy time is that chance level, so the excess
is the idle time the launches explain beyond it.  High: the card idles
while the callers enqueue, more than it works while they do.  Near 0: the
launches cover idle and busy time alike, and the idle time has another
cause (the ingest, Horner, the interpreter lock).  The spans are put on the
window's clock as ``t_ns / 1e9 - run.w0``; the device's busy time is the
union of its records, the idle time the rest of the window."""

from benchmark.core import records, stats

UNIT, SOURCE = "%", "device_trace"
LAYER, MOVES = "device", "msm_points_per_s"


def _meet(xs, ys) -> float:
    """Seconds covered by both of two sorted lists of disjoint intervals."""
    i = j = 0
    out = 0.0
    while i < len(xs) and j < len(ys):
        out += stats.overlap(*xs[i], *ys[j])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def read(run):
    dev = run.device
    if dev is None or dev.busy_s <= 0:
        return None
    launches = records.intervals(run, "msm: launches (host)")
    if launches is None:
        return None
    busy = stats.union(stats.clip([(a, b) for a, b, _, _ in dev.ops], 0.0,
                                  dev.window_s))
    idle = sorted(stats.gaps(busy, 0.0, dev.window_s))
    busy_s = sum(b - a for a, b in busy)
    idle_s = sum(b - a for a, b in idle)
    if idle_s <= 0 or busy_s <= 0:
        return None
    inside = stats.union(stats.clip(launches, 0.0, dev.window_s))
    return (_meet(idle, inside) / idle_s - _meet(busy, inside) / busy_s) * 100
