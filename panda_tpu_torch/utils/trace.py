"""Per-phase timing, span records and whole-program traces.

Counterpart of ``panda_tpu/utils/trace.py``, with the same two mechanisms:

* :func:`timer` / :class:`span` print ``Start:`` / ``End:`` lines when
  ``PANDA_PRINT_TRACE`` is set to anything but ``0`` or empty;
* every timed phase is recorded in the in-memory :data:`phase_times`
  registry, read with :func:`summary`, cleared with :func:`reset`.

Beside its entry in :data:`phase_times`, every span leaves one
:class:`Record` in a ring of the last :data:`RING_SIZE` records (read with
:func:`records`; :func:`dropped` counts those the ring let go): its id, the
id of the span open around it on its thread, the id of its call (the
thread's open ``*: call`` span, which is its own call), its label and
thread, its start and end on ``time.perf_counter_ns()`` and the thread's
CPU time in it (``time.thread_time_ns()``).  Recording is always on.
Where that clock advances in scheduler ticks (10 ms on some hosts), a
span's CPU time is a whole number of ticks, above its wall time or 0:
read the CPU time of many spans as a sum, never one span against its
wall.

CUDA work runs asynchronously.  ``block`` (a tensor or a sequence of
tensors) makes the timer synchronise the CUDA devices they lie on before
it stops the clock, so the phase holds its device time; CPU tensors need
no wait.  The byte API blocks its device phases only while printing is on
(:func:`wait`): with printing off a device phase records its launches and
the wait falls in the next phase that copies to the host.

:func:`profile_to` wraps ``torch.profiler.profile`` (CPU and, where there
is a GPU, CUDA activity) with a TensorBoard trace handler.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Iterator, NamedTuple

import torch

phase_times: dict[str, list[float]] = collections.defaultdict(list)

RING_SIZE = 1 << 16
CALL = ": call"          # the label's end that makes a span a call


class Record(NamedTuple):
    """One span: ``parent`` and ``call`` are span ids (None outside any);
    times in ns."""
    id: int
    parent: int | None
    call: int | None
    label: str
    thread: int
    t0_ns: int
    t1_ns: int
    cpu_ns: int


_ring: collections.deque = collections.deque(maxlen=RING_SIZE)  # tuples
_dropped = 0
_ring_lock = threading.Lock()
_ids = itertools.count(1)


class _Local(threading.local):
    def __init__(self):
        self.stack = []        # (id, call id) of the thread's open spans


_local = _Local()


def enabled() -> bool:
    """True when ``PANDA_PRINT_TRACE`` asks for printed phases."""
    return os.environ.get("PANDA_PRINT_TRACE", "0") not in ("", "0")


def _sync(block) -> None:
    """Synchronise every CUDA device that holds a tensor of ``block`` (a
    tensor, or a possibly nested sequence of tensors)."""
    if block is None:
        return
    if isinstance(block, torch.Tensor):
        if block.device.type == "cuda":
            torch.cuda.synchronize(block.device)
        return
    for item in block:
        _sync(item)


def wait(block) -> None:
    """Synchronise ``block``'s CUDA devices while printing is on, so a
    printed phase holds its device time; otherwise nothing."""
    if enabled():
        _sync(block)


def _record(label: str, dt: float) -> None:
    phase_times[label].append(dt)
    if enabled():
        print(f"End:   {label} {dt * 1e3:.3f}ms")


class span:
    """Imperative start/end pair: ``t = span("label"); ...; t.end()``."""

    block = None

    def __init__(self, label: str):
        self.label = label
        if enabled():
            print(f"Start: {self.label}")
        self.id = next(_ids)
        self._stack = stack = _local.stack   # end() may run elsewhere
        self.parent, call = stack[-1] if stack else (None, None)
        self.call = self.id if label.endswith(CALL) else call
        stack.append((self.id, self.call))
        self.thread = threading.get_ident()
        self._cpu0 = time.thread_time_ns()
        self._t0 = time.perf_counter_ns()

    def __enter__(self) -> "span":
        return self

    def __exit__(self, *exc) -> None:
        self.end(self.block)

    def end(self, block=None) -> float:
        global _dropped
        _sync(block)
        t1 = time.perf_counter_ns()
        cpu = time.thread_time_ns() - self._cpu0
        entry = (self.id, self.call)
        if entry in self._stack:               # not when ended twice
            self._stack.remove(entry)
        rec = (self.id, self.parent, self.call, self.label, self.thread,
               self._t0, t1, cpu)
        with _ring_lock:
            _dropped += len(_ring) == _ring.maxlen
            _ring.append(rec)
        dt = (t1 - self._t0) / 1e9
        _record(self.label, dt)
        return dt


class timer(span):
    """``with timer(label, block):`` times a phase into :data:`phase_times`
    and the records, and prints when enabled.  ``block``: tensors whose
    CUDA devices are synchronised before the clock stops."""

    def __init__(self, label: str, block=None):
        super().__init__(label)
        self.block = block


def records() -> list[Record]:
    """A copy of the ring's records, oldest first (by end)."""
    with _ring_lock:
        ring = list(_ring)
    return [Record._make(r) for r in ring]


def dropped() -> int:
    """Records the ring let go since the last :func:`reset`."""
    return _dropped


def reset() -> None:
    global _dropped
    phase_times.clear()
    with _ring_lock:
        _ring.clear()
        _dropped = 0


def summary() -> dict[str, dict[str, float]]:
    """{label: {count, total_s, mean_s, last_s}} for everything recorded."""
    return {label: {"count": len(xs), "total_s": sum(xs),
                    "mean_s": sum(xs) / len(xs), "last_s": xs[-1]}
            for label, xs in phase_times.items()}


@contextlib.contextmanager
def profile_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A torch.profiler trace of the region (CPU activity, and CUDA where a
    GPU is present) written to ``log_dir`` in TensorBoard's format."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
