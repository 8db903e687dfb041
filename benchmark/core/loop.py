"""The closed loop: callers (threads) that share one session and each send
their next call as soon as the last one returned.

The window opens once every caller has had one call back, so the loop is
in its steady state, and closes ``seconds`` later.  No call is issued after
it closes; the calls in flight then are waited for (their answers are
checked like every other) and count for the part of them inside the window.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from dataclasses import dataclass

# How long the loop waits past the window's close for calls in flight.
DRAIN_S = 60.0


@dataclass
class Call:
    caller: int
    k: int
    key: str
    work: int
    t0: float
    t1: float
    answer: int | None = None      # index of the distinct answer for key
    error: str | None = None
    thread: int = 0


class Answers:
    """The distinct answers returned for each key, by their SHA-256; each
    call keeps the index of its own.  One thread of its own hashes them, so
    a caller sends its next call as soon as the last one returned."""

    def __init__(self):
        self.by_key: dict = {}
        self._queue: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._hash, name="hasher",
                                        daemon=True)
        self._thread.start()

    def add(self, rec: Call, blob: bytes) -> None:
        """Hash ``blob`` and set ``rec.answer``, in the hashing thread."""
        self._queue.put((rec, blob))

    def _hash(self) -> None:
        while (item := self._queue.get()) is not None:
            rec, blob = item
            seen = self.by_key.setdefault(rec.key, [])
            d = digest(blob)
            if d not in seen:
                seen.append(d)
            rec.answer = seen.index(d)

    def close(self) -> None:
        """Wait until every answer is hashed."""
        self._queue.put(None)
        self._thread.join()


def digest(blob: bytes) -> bytes:
    return hashlib.sha256(blob).digest()


def closed_loop(callers: int, job, call, seconds: float, on_open=None,
                on_close=None):
    """Run ``callers`` threads: caller c's k-th call is ``call(key)`` with
    ``(key, work) = job(c, k)``.  Returns (calls, answers, w0, w1)."""
    calls, answers = [], Answers()
    lock = threading.Lock()
    first = [threading.Event() for _ in range(callers)]
    state = {"stop_at": float("inf")}

    def run(c: int) -> None:
        k = 0
        while time.perf_counter() < state["stop_at"]:
            key, work = job(c, k)
            t0 = time.perf_counter()
            try:
                blob, err = call(key), None
            except Exception as e:          # a failed call is counted
                blob, err = None, f"{type(e).__name__}: {e}"
            t1 = time.perf_counter()
            rec = Call(c, k, key, work, t0, t1, error=err,
                       thread=threading.get_ident())
            if blob is not None:
                answers.add(rec, blob)
            with lock:
                calls.append(rec)
            first[c].set()
            k += 1
            if err is not None:          # a caller stops at its first fault
                break

    threads = [threading.Thread(target=run, args=(c,), name=f"caller-{c}",
                                daemon=True) for c in range(callers)]
    for t in threads:
        t.start()
    for ev in first:
        if not ev.wait(timeout=DRAIN_S * 5):
            state["stop_at"] = 0.0
            raise RuntimeError("a caller's first call did not return")
    w0 = time.perf_counter()
    if on_open:
        on_open()
    state["stop_at"] = w0 + seconds
    time.sleep(max(0.0, state["stop_at"] - time.perf_counter()))
    w1 = state["stop_at"]
    if on_close:
        on_close()
    deadline = time.perf_counter() + DRAIN_S
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a call did not return within a minute of the "
                           "window's close")
    answers.close()
    return sorted(calls, key=lambda r: r.t0), answers, w0, w1
