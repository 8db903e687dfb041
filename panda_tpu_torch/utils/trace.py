"""Per-phase timing and whole-program traces.

Counterpart of ``panda_tpu/utils/trace.py``, with the same two mechanisms:

* :func:`timer` / :class:`span` print ``Start:`` / ``End:`` lines when
  ``PANDA_PRINT_TRACE`` is set to anything but ``0`` or empty;
* every timed phase is recorded in the in-memory :data:`phase_times`
  registry, read with :func:`summary`, cleared with :func:`reset`.

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
import os
import time
from typing import Iterator

import torch

phase_times: dict[str, list[float]] = collections.defaultdict(list)


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


@contextlib.contextmanager
def timer(label: str, block=None) -> Iterator[None]:
    """Time a phase into :data:`phase_times`; print when enabled.
    ``block``: tensors whose CUDA devices are synchronised before the clock
    stops."""
    if enabled():
        print(f"Start: {label}")
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(block)
        _record(label, time.perf_counter() - t0)


class span:
    """Imperative start/end pair: ``t = span("label"); ...; t.end()``."""

    def __init__(self, label: str):
        self.label = label
        if enabled():
            print(f"Start: {self.label}")
        self.t0 = time.perf_counter()

    def end(self, block=None) -> float:
        _sync(block)
        dt = time.perf_counter() - self.t0
        _record(self.label, dt)
        return dt


def reset() -> None:
    phase_times.clear()


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
