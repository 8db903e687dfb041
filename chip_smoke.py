#!/usr/bin/env python3
"""Smoke run of panda_tpu_torch on one CUDA device.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. environment: torch, CUDA, nvcc, the card's name and power limit;
2. build the ten CUDA kernels from panda_tpu_torch/csrc, in parallel,
   and log each kernel entry's registers and spills (the build's ptxas -v
   reports), each
   template instantiation by its curve or field, the BN254 ones beside
   their registers from before the kernels took a curve;
3. each kernel against its plain PyTorch version on the card, at its main
   path's shapes: the six MSM kernels at n = 2^16 points (c = 13, W = 20,
   D = 4096) and at n = 2^20 (c = 16, W = 16, D = 32768) for BN254, and
   for BLS12-377 and BLS12-381 (12-word coordinates, c from the scalar
   field's bits, the same geometry) at 2^16 and 2^20 (where phase A is
   also timed with its indices cut below n / 8, the bases' table in L2, a
   measurement only): exact equality for
   the digits, the histogram and phase A (keys, tails, and emissions where
   a run ended; its bucket tables point-equal), point equality for the
   bucket assembly (buckets.cu's two launches against the plain gathers,
   scan and add, on a draw from 2^16 pool scalars and on the digits of 8
   pool scalars, whose buckets span hundreds of lanes, each launch timed
   on its own), the point ops on the bucket tables' shape (padd, pmadd,
   pdbl with k = 1 and k = c, each timed against its bound) and the
   weighted reduction (wscan's two launches against the plain
   decomposition, timed level by level); fmul
   at (8, 2^20), the DFT at K = 32, nb = 2^15 (the
   four-step 2^20 NTT's passes), forward and with the inverse's scale and
   the canonical pass, and at K = 4, nb = 2^20 (the 2^22 NTT's leaf), and
   the radix-2 pass small_ntt at the radix-2 2^20 NTT's three passes
   (K = 256, nb = 2^12 with its T1 table, read as runs of 1; K = 64,
   nb = 2^14 with its T1 table, runs of 256; the leaf, K = 64 in the
   natural layout) and the 2^22 NTT's K = 128 middle pass (an odd log_k),
   each in the layout the recursion hands it and with each launch's blocks
   and waves, forward and with the inverse's scale and the canonical
   store, on words that include values >= 2r (for BLS12-381 Fr, whose
   values stay below r, words >= r only where the kernel reduces at
   load): equal words, for BN254 Fr, BLS12-377 Fr and BLS12-381 Fr, each
   timed; the gather probe's dg3 at its four depths R = 8, 32, 256 and
   1024 (G = 2^22 / (128 R)): equal words, each launch's geometry and its
   device ms against torch.gather's (the kernels line gives R = 8's
   times).  Each
   kernel's device time a launch (the median of torch.profiler's CUDA
   kernel records over a batch of calls) and the batch's time from CUDA
   events, beside the least time the card could take (bytes over 3.35
   TB/s or operations over the peak rate, the larger) and, where one
   PyTorch call computes the same function, that call's time
   (torch._int_mm beside the DFT as a yardstick of the int8 tensor cores,
   torch.gather beside dg3).  Every curve and scalar field has a kernel id
   (MSM curve, digits field, NTT field);
4. the main paths, each with every launch counter set to 0 just before it
   and read after it (each of its kernels must have launched): the MSM
   slice, api.msm_bn254_with_cached_bases at n = 2^16 and 2^20 with cached
   bases, every call held to the pool-aggregated big-integer oracle, host
   wall time of 20 calls (point_ops must not launch on an MSM path up to
   2^20 points); the point API (msm.horner: point_kernels.pdbl with
   k = c and curves.point.add, kernel point_ops, 2W launches) over the
   2^16 call's window sums on the card, held to the host's Horner and the
   oracle; the BLS MSMs, each curve counted on
   its own, after a check that the bases ingest on the card equals the
   CPU's for 48-byte coordinates: api.msm_bls12_377 / api.msm_bls12_381
   (bases bytes in every call) and api.msm_with_cached_bases at 2^16 and
   2^20, 5 timed calls at 2^16, 10 (alias) and 20 (cached) at 2^20, every
   blob equal to the oracle's; the array-level msm.msm (window sums, then
   msm.horner on the card) at 2^16 and 2^20 (BN254) and 2^20
   (BLS12-381), equal to the oracle, with 2W point_ops launches (and
   chunks - 1 more above 2^20);
   fold_sum, total_sum and scalar_mul (a full-width scalar) on 2^16 points
   on the card, equal to the host's big integers; the MSM above 2^20:
   api.msm_with_cached_bases (BN254 through its alias) at 2^22 and 2^24
   for the three curves, a first call and 3 (2^22) or 2 (2^24) timed
   calls, each blob equal to the oracle's, each size counted on its own
   with exactly the chunked path's launches (a chunk of 2^20 points runs
   hist, phase A and the bucket assembly once a window group, padd sums
   the chunks' tables chunks - 1 times, wscan launches twice, digits
   once); for BN254 at 2^22 and 2^24 a measurement of the chunks against
   window groups alone (msm.CHUNK_N = n): byte-API calls in the order
   chunked, groups, groups, chunked, the window sums' CUDA-event ms, peak
   memory and launches; api.msm_host (the native C++ library, no
   kernel) for the three curves at 2^12 in both coordinate types, each
   blob equal to the one computed from the oracle and the blob's Z;
   api.ntt_v1 with a zero root at 2^10 under auto, mxu and pallas, equal
   to the stagewise engine's bytes (fmul must launch, dft and small_ntt
   must not); the NTT
   byte API with the four-step engine
   (PANDA_NTT_IMPL=auto): api.ntt_bn254, api.intt and api.ntt_bn254_v1 (a
   non-default root) at 2^20 and 2^22, held to a bit-exact INTT roundtrip
   and 4 big-integer spot checks each, and at 2^12 to the NTT oracle byte
   for byte; 20 timed calls (10 at 2^22) and the device time of run_ntt
   alone; the same with the radix-2 engine (PANDA_NTT_IMPL=pallas), whose
   bytes must equal the four-step engine's, and whose steady 2^20 call
   must launch small_ntt and no dft; the BLS12-377 NTT with both engines,
   at 2^12 against the oracle and at 2^20 (roundtrip, spot checks, 10
   timed calls); the BLS12-381 NTT likewise, each engine counted on its
   own (the four-step path must launch fmul and dft, the radix-2 path
   small_ntt and no dft); the stagewise engine (PANDA_NTT_IMPL=jnp), each
   field counted on its own (fmul must launch, dft and small_ntt must
   not): its 2^12 bytes equal ntt_ref's for the three fields, BN254 at
   2^20 (roundtrip, spot checks, 3 timed calls), and run_ntt at 2^8 with
   auto, which runs the stagewise engine there, byte-equal to the
   four-step plan (impl mxu, run before the count), each timed; the
   gather probe (tools/profile_gather4.py's port,
   panda_tpu_torch.tools.profile_gather4.main) at its full sizes, whose
   dg3 cases must launch dg3, and then one measurement beside it: 2^24
   lookups of a base point in phase A's own layout (index_select from the
   (8, 2^20) word tensors of the 2^20 MSM session), beside the probe's
   R = 16 row gather and phase A's device ms a launch at 2^20; then the
   multi-rank paths (parallel.cluster.spawn of entry.sharded_cases; the
   machine has one card): four gloo ranks sharing cuda:0 run the
   points-sharded BN254 MSM at 2^22, the windows-sharded at 2^20, the
   2 x 2 MSM at 2^22 and BLS12-381 points-sharded at 2^20 (each rank's
   point equal to the pool-aggregated oracle's, whose blob the
   single-device byte API returns), and the sharded NTT, four-step at
   2^22 forward and inverse and stagewise at 2^12 (BN254 Fr) and
   four-step at 2^20 (BLS12-381 Fr), the ranks' chunks byte-equal to the
   single-device run_ntt's; each rank's launches of one call (its path's
   kernels must launch) and the median of 3 timed calls, four ranks
   time-sharing one card (no scaling figure); one NCCL rank runs the
   points-sharded MSM and the sharded NTT at 2^20; a block of zero-digit
   windows sums to the identity on the card; entry.dryrun_multichip(4)
   and (1); the native caller: panda_tpu_torch.tools.native_engine_check
   in a process of its own that imports no torch (so holds no CUDA
   context), as a Rust prover linking the port's libpanda_host.so runs:
   for BN254 and BLS12-381, the engine target's MSM at 2^16 by cached
   bases and scalars indices and by cached bases with fresh scalar bytes
   equal to the pool-aggregated oracle, NTT, INTT and ntt_v1 (w^3) at 2^12
   equal to ntt_ref, and the host target's set_config(1), device_count()
   and ntt_host; each worker one more compute app in nvidia-smi while it
   lives, returning call by call the bytes (by sha256) and launching the
   kernels that the same call returns and launches in this script's
   process;
5. where the time goes: the MSM call (BN254 at 2^16, 2^20 and, 3 calls,
   2^24; BLS12-381 at 2^20) and the 2^20 NTT call of each engine run stage
   by stage with a device synchronise around each stage, median, min and
   max of 10 calls;
6. the device's busy share of one call each (MSM 2^16, 2^20 and 2^24,
   BLS12-377 and BLS12-381 MSM 2^20, NTT 2^20 and 2^22 with each engine),
   and each kernel's launches and device ms in that call, from
   torch.profiler (a 2^20 MSM call launches hist once and point_ops never,
   a 2^24 call exactly the chunked path's launches, whose digits and padd
   launches are set beside their bounds); each kernel of a 2^20 call
   ranked by its device ms less its launches' bounds, each at its own
   shape.

The second-to-last line is a JSON object with one entry per kernel (the
five curve-templated MSM kernels with a record for each curve, the three
NTT kernels with one for each scalar field; the "ms" of buckets and of
wscan is a call's two launches together); the last line is
{"ok": true, "device": {...}}.  Inputs come from fixed seeds.

A native caller reaches the port through its own C library,
panda_tpu_torch/native/panda_host.cpp, which panda_tpu_torch/interop/
native.py builds with g++ at first use into build/panda_tpu_torch/ and
leaves as build/panda_tpu_torch/native/libpanda_host.so as well (python3
-c 'from panda_tpu_torch.interop import native; print(native.build())').
The Rust crate links it with PANDA_NATIVE_DIR set to that directory (no
check in this repository builds the crate).  A session with execution target
1 starts "$PANDA_WORKER_PYTHON -m panda_tpu_torch.interop.worker" (an
interpreter, default python3) with the repository root on PYTHONPATH;
PANDA_WORKER_DEVICE=cpu serves on the CPU, as the CPU tests
(tests/test_torch_native_session.py, tests/test_torch_native_engine.py)
run it.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import random
import re
import statistics
import subprocess
import sys
import time

import numpy as np

from panda_tpu_torch.tools.bounds import (IMAD_PER_S, INT8_OPS_PER_S,
                                         MONT_MUL_IMADS, bound,
                                         cios_imads)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def host_cpu_model() -> str:
    """The host CPU's model name, which tells two runs' machines apart."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "model unknown"


def ptxas_usage() -> dict:
    """Registers, stack frame and spill bytes of every kernel entry, from
    the build's ``ptxas -v`` reports (build first).  Returns {source:
    [(entry, registers, stack, spill stores, spill loads)]}."""
    from panda_tpu_torch.ops import _ext
    return {name: _ext.ptxas_rows(name) for name in _ext.KERNELS}


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls
    between one pair of CUDA events, after one warm-up call: the batch
    time a call.  A kernel shorter than its wrapper's host work (checks,
    allocation, the launch) is paced by the host here; DeviceTimes gives
    the device time a launch."""
    import torch
    fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# The kernels of each kernel library, by the names the profiler records.
KERNEL_NAMES = {"digits": ("digits_kernel",), "hist": ("hist_kernel",),
                "phase_a": ("phase_a_kernel",),
                "buckets": ("buckets_tails_kernel", "buckets_fill_kernel"),
                "point_ops": ("padd_kernel", "pmadd_kernel", "pdbl_kernel"),
                "wscan": ("wscan_kernel",), "fmul": ("fmul_kernel",),
                "dft": ("dft_kernel",), "small_ntt": ("small_ntt_kernel",),
                "dg3": ("dg3_kernel",)}


def kernel_records(events, names, within=None) -> list:
    """Device microseconds of each kernel record among ``events`` (a
    finished torch.profiler run's events) whose name contains one of
    ``names``, and whose midpoint lies in the time range ``within`` if
    given."""
    from torch.autograd import DeviceType
    return [e.time_range.end - e.time_range.start for e in events
            if e.device_type == DeviceType.CUDA
            and any(n in e.name for n in names)
            and (within is None or within.start
                 <= (e.time_range.start + e.time_range.end) / 2
                 <= within.end)]


def profile_ranges(jobs):
    """Run ``jobs`` (label, callable) in one torch.profiler session (CPU and
    CUDA activity), each inside a record_function range that ends with a
    device synchronise; returns (each job's result, the session's events,
    each label's time range).  One session for a whole phase: on the H100
    runs, one session per measurement lost kernel records from about the
    dozenth session on, and whole sessions' records later."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    out = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, job in jobs:
            with record_function(label):
                out.append(job())
                torch.cuda.synchronize()
    events = prof.events()
    labels = {label for label, _ in jobs}
    ranges = {e.name: e.time_range for e in events if e.name in labels}
    return out, events, ranges


class DeviceTimes:
    """Per-launch device times from torch.profiler's CUDA kernel records
    (CUPTI), so the host's pace does not enter.  ``add`` queues a batch of
    ``reps`` calls of a kernel's wrapper and the dict whose "ms" it fills;
    ``take`` runs every queued batch (each after one warm-up call) in one
    profiler session and fills in the median device ms a launch.  On the
    H100 a session at times records no launch of a whole batch (its first,
    or one in the middle of a long session): so each session opens with
    an extra batch of its first kernel, whose records are not read, and a
    batch left without records runs again in a new session, up to
    ``RETRIES`` times, and the retries are logged; phase 3 takes a group
    of kernels a session."""

    RETRIES = 2

    def __init__(self):
        self.jobs, self.sums, self.copies = [], [], []

    def add(self, fn, reps: int, names, out: dict) -> None:
        """Queue ``reps`` calls of ``fn``, one launch of ``names`` each."""
        self.jobs.append((fn, reps, names, out))

    def add_sum(self, parts, reps: int, names, out: dict) -> None:
        """A call of several launches of different sizes: ``parts`` holds
        one callable a launch, on that launch's own inputs.  Each part is
        its own batch, and "ms" is the sum of the parts' medians, the device
        ms a call ("parts_ms" each part's)."""
        rows = [{} for _ in parts]
        for fn, row in zip(parts, rows):
            self.add(fn, reps, names, row)
        self.sums.append((out, rows))

    def copy(self, src: dict, out: dict) -> None:
        """Fill ``out``'s "ms" and "recorded" from ``src``'s batch."""
        self.copies.append((src, out))

    def take(self) -> None:
        def batch(fn, reps):
            def run():
                for _ in range(reps):
                    fn()
            return run

        pending = list(enumerate(self.jobs))
        for attempt in range(self.RETRIES + 1):
            fn, reps = pending[0][1][:2]
            jobs = [("chip_smoke session start", batch(fn, reps))]
            for i, (fn, reps, *_) in pending:
                jobs += [(f"chip_smoke warm-up {i}", fn),
                         (f"chip_smoke batch {i}", batch(fn, reps))]
            _, events, ranges = profile_ranges(jobs)
            lost = []
            for i, job in pending:
                fn, reps, names, out = job
                us = kernel_records(events, names,
                                    ranges[f"chip_smoke batch {i}"])
                if not us:
                    lost.append((i, job))
                    continue
                out["ms"] = statistics.median(us) / 1e3
                out["recorded"] = f"{len(us)} of {reps}"
                if attempt:
                    out["recorded"] += f" (session {attempt + 1})"
            if lost:
                log(f"[profiler] session {attempt + 1} recorded no launch in "
                    f"batches {[i for i, _ in lost]} of {len(self.jobs)}")
            pending = lost
            if not pending:
                break
        if pending:
            raise AssertionError(f"the profiler recorded no launch of "
                                 f"{[j[2] for _, j in pending]} in "
                                 f"{self.RETRIES + 1} sessions")
        for out, rows in self.sums:
            out["ms"] = sum(r["ms"] for r in rows)
            out["parts_ms"] = [r["ms"] for r in rows]
            out["recorded"] = " + ".join(r["recorded"] for r in rows)
        for src, out in self.copies:
            out["ms"], out["recorded"] = src["ms"], src["recorded"]
        self.jobs, self.sums, self.copies = [], [], []


def word_err(a, b) -> int:
    """Max absolute difference of two word tensors read as uint32."""
    import torch
    u = lambda t: t.to(torch.int64) & 0xFFFFFFFF
    return int((u(a) - u(b)).abs().max().item()) if a.numel() else 0


_POOLS: dict = {}


def pool_points(curve, seed: int, count: int) -> list:
    """``count`` random points of ``curve`` from ``seed``, made once a run
    (a random multiple of the generator each: seconds of host big
    integers)."""
    from panda_tpu_torch.reference import curve_ref
    key = (curve.name, seed, count)
    if key not in _POOLS:
        rng = random.Random(seed)
        _POOLS[key] = [curve_ref.random_point(curve, rng)
                       for _ in range(count)]
    return _POOLS[key]


def pool_inputs(curve, n: int, seed: int, oracle: bool = True):
    """Pool-structured MSM inputs: <= 1024 distinct random points (one pool
    a curve and seed) and a pool of full-range scalars, indexed by numpy
    draws that depend on n too.  Returns the bases and scalar blobs and
    the pool-aggregated oracle result (None when ``oracle`` is False)."""
    from panda_tpu_torch.fields import mont
    from panda_tpu_torch.reference import curve_ref
    fp, fr = curve.fp, curve.fr
    pts = pool_points(curve, seed, min(n, 1024))
    rng = random.Random(seed + 1)
    npr = np.random.default_rng([seed, n])
    svals = [rng.randrange(fr.modulus) for _ in range(min(n, 1 << 16))]
    pidx = npr.integers(len(pts), size=n)
    sidx = npr.integers(len(svals), size=n)
    xw = mont.ints_to_words(fp, [fp.to_wire_int(x) for x, _ in pts])
    yw = mont.ints_to_words(fp, [fp.to_wire_int(y) for _, y in pts])
    sw = mont.ints_to_words(fr, [fr.to_wire_int(s) for s in svals])
    table = np.ascontiguousarray(np.concatenate([xw.T, yw.T], axis=1))
    bases = table[pidx].tobytes()                 # x || y a point, LE words
    scalars = np.ascontiguousarray(sw.T)[sidx].tobytes()
    if not oracle:
        return bases, scalars, None
    return bases, scalars, curve_ref.msm_oracle(curve, pts, aggregate(
        pidx, sidx, mont.ints_to_words(fr, svals), fr.modulus, len(pts)))


def aggregate(pidx, sidx, words, r: int, points: int) -> list:
    """agg[p] = the sum, mod r, of the pool scalars drawn beside pool point
    p, the scalars given as their (8, S) plain 32-bit words: one float64
    bincount a word, exact while a point's draws times 2^32 stay below
    2^53."""
    if np.bincount(pidx, minlength=points).max() >= 1 << 21:
        raise ValueError("aggregate: too many draws of one point")
    sums = [np.bincount(pidx, weights=w.astype(np.float64)[sidx],
                        minlength=points) for w in words]
    return [sum(int(col[p]) << (32 * j) for j, col in enumerate(sums)) % r
            for p in range(points)]


def kernel_checks(curve, n: int, device, timer: DeviceTimes,
                  plain_times: bool = True) -> dict:
    """Phase 3: each MSM kernel of ``curve`` against its plain version at
    the main-path shapes for n points.  The bucket assembly runs on two
    inputs: these digits and those of 8 pool scalars ("long_runs"); the
    point ops (padd, pmadd, pdbl with k = 1 and k = c) on the bucket
    tables' shape.  Returns {kernel: {max_abs_err,
    batch_ms (CUDA events around a batch), plain_ms (None unless
    ``plain_times``), bound_ms, bound_by, library_ms}}; ``timer`` fills in
    "ms", the device ms a launch (for wscan, the sum of its levels'), when
    it takes its batches.  Bounds count L = 8 or 12 words
    a coordinate (fe bytes a field element, cios_imads(L) a multiply); the
    digits' one multiply is over the 8-word scalar field."""
    import torch
    from panda_tpu_torch.curves import point as cp
    from panda_tpu_torch.curves.point import AffinePoint, ProjPoint
    from panda_tpu_torch.fields import mont
    from panda_tpu_torch.ops import (digits, hist, msm, phase_a,
                                     point_kernels, reduce)
    from panda_tpu_torch.runtime.manager import PandaManager

    res = {}
    L = mont.n_words(curve.fp)
    fe = 4 * L
    imad = lambda muls: muls * cios_imads(L)             # noqa: E731
    c = msm.window_bits((n - 1).bit_length(), bits=curve.fr.bits)
    W = msm.signed_window_count(curve.fr.bits, c)
    D = 1 << (c - 1)
    wave = phase_a.resident_threads(curve, device)
    m = msm.default_lanes(n, W, wave)
    tag = f"[kernels {curve.name} 2^{n.bit_length() - 1}]"
    log(f"{tag} n={n} c={c} W={W} D={D} lanes={m} L={L}; resident threads: "
        f"phase A {wave}, wscan {reduce.wscan_threads(curve, device)}")
    bases, scalars, _ = pool_inputs(curve, n, 7, oracle=False)
    gm = PandaManager.new(0, curve, device=device)
    px, py = gm.ingest_bases(bases)
    pts = phase_a.point_major(px, py)
    s = gm.ingest_scalars(scalars)

    def timed(fn, reps, names, parts=None):
        """A kernel call's batch ms now; its device ms a launch (a call,
        summed over ``parts``, one callable a launch) queued."""
        out = {"batch_ms": cuda_ms(fn, reps)}
        if parts:
            timer.add_sum(parts, reps, names, out)
        else:
            timer.add(fn, reps, names, out)
        return out

    def plain_ms(fn, reps):
        return cuda_ms(fn, reps) if plain_times else None

    def record(name, err, ms, plain, ok, bnd, library_ms=None):
        log(f"{tag} {name}: max_abs_err={err} "
            f"kernel {ms['batch_ms']:.4f} ms batch-timed, plain {plain} ms, "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), library "
            f"{library_ms} ms")
        if not ok:
            raise AssertionError(f"{name} ({curve.name}): kernel disagrees "
                                 "with plain")
        ms.update({"max_abs_err": err, "plain_ms": plain, **bnd,
                   "library_ms": library_ms})
        res[name] = ms

    # 1. signed digits: exact
    km, kn = digits.signed_digits(curve.fr, s, c, W)
    pm, pn = digits.signed_digits_plain(curve.fr, s, c, W)
    err = max(word_err(km, pm), word_err(kn.int(), pn.int()))
    record("digits", err,
           timed(lambda: digits.signed_digits(curve.fr, s, c, W), 20,
                 KERNEL_NAMES["digits"]),
           plain_ms(lambda: digits.signed_digits_plain(curve.fr, s, c, W), 2),
           torch.equal(km, pm) and torch.equal(kn, pn),
           bound(n * 32 + W * n * 5, n * MONT_MUL_IMADS, IMAD_PER_S))

    # 2. histogram of the digits: exact; the library call is one bincount
    #    of the digits offset by w (D + 2) (digit 0 and dead keys binned too)
    kh, ph = hist.hist_counts(km, D), hist.hist_counts_plain(km, D)
    offs = (km.clamp(0, D + 1).long() + torch.arange(
        W, device=device)[:, None] * (D + 2)).reshape(-1)
    lib = cuda_ms(lambda: torch.bincount(offs, minlength=W * (D + 2)), 20)
    record("hist", word_err(kh, ph),
           timed(lambda: hist.hist_counts(km, D), 20, KERNEL_NAMES["hist"]),
           plain_ms(lambda: hist.hist_counts_plain(km, D), 5),
           torch.equal(kh, ph), bound(W * n * 4 + W * D * 4, 0, IMAD_PER_S),
           lib)
    # ... and exact where whole warps share a digit (every add of a warp to
    #    one shared bin): one digit a window, from 1 up to D
    one = (torch.arange(W, device=device, dtype=torch.int32) * 997 % D +
           1)[:, None].expand(W, n).contiguous()
    one[-1] = D
    hist_exact(hist, one, D, "one digit a window")
    res["hist"]["one_digit"] = timed(lambda: hist.hist_counts(one, D), 20,
                                     KERNEL_NAMES["hist"])

    # 3. phase A: exact keys and tails, exact emissions where a run ended,
    #    and the bucket tables it yields; the work this data needs is one
    #    mixed add per entry with a digit in 1..D, and a stored sum per run
    #    end
    st = msm.sorted_streams(km, kn, c, m)
    live = int(((st.keys >= 1) & (st.keys <= D)).sum().item())
    P = st.keys.numel()
    ka = phase_a.scan(curve, st.keys, st.sidx, px, py, D + 1, pts)
    pa = phase_a.scan_plain(curve, st.keys, st.sidx, px, py, D + 1)
    ended = pa[0] != D + 1
    kb = msm.assemble_buckets(curve, st, *ka)
    pb = msm.assemble_buckets_plain(curve, st, *pa)
    ok = torch.equal(ka[0], pa[0]) and torch.equal(ka[2], pa[2]) and all(
        torch.equal(a, b) for a, b in zip(ka[3], pa[3])) and all(
        torch.equal(a[:, ended], b[:, ended]) for a, b in zip(ka[1], pa[1])) \
        and bool(cp.eq(curve, kb, pb).all())
    # (its own outputs; the tables, other projective representatives since
    # the bucket assembly is buckets.cu, are point-equal above and the
    # bucket assembly's record)
    err = max(word_err(a, b) for a, b in zip(
        (*ka[3], *(t[:, ended] for t in ka[1])),
        (*pa[3], *(t[:, ended] for t in pa[1]))))
    runs = int(ended.sum().item())
    log(f"{tag} phase_a: {W} windows x {m} lanes x {st.keys.shape[1]} steps "
        f"in one launch; {live} mixed adds, {runs} run sums stored")
    record("phase_a", err,
           timed(lambda: phase_a.scan(curve, st.keys, st.sidx, px, py,
                                      D + 1, pts), 5, KERNEL_NAMES["phase_a"]),
           plain_ms(lambda: phase_a.scan_plain(curve, st.keys, st.sidx, px,
                                               py, D + 1), 1), ok,
           bound(P * 12 + px.shape[1] * 2 * fe + runs * 3 * fe +
                 W * m * (4 + 3 * fe), imad(11 * live), IMAD_PER_S))
    if n >= 1 << 20:
        # measurements only: the same launch with every point index cut
        # below n / 8, so the bases' table (2 x 4 or 6 MiB) sits in the
        # 50 MB L2 (what it saves is what is left of the gather from the
        # full table)
        cut = n // 8 - 1
        low = torch.where(st.sidx < 0, (st.sidx & cut) | -(1 << 31),
                          st.sidx & cut)
        scan_l2 = lambda: phase_a.scan(curve, st.keys, low, px, py,  # noqa
                                       D + 1, pts)
        res["phase_a_l2"] = {**res["phase_a"],
                             "batch_ms": cuda_ms(scan_l2, 5),
                             "table_bytes": 2 * fe * (cut + 1)}
        timer.add(scan_l2, 5, KERNEL_NAMES["phase_a"], res["phase_a_l2"])

    # 3b. the bucket assembly (buckets.cu's tails and table launches) on
    #    phase A's outputs against assemble_buckets_plain on the same
    #    inputs, point-equal: these digits (a draw from 2^16 pool scalars,
    #    close to uniform) and digits of 8 pool scalars, whose buckets each
    #    span hundreds of lanes (long tail runs, a look-back over blocks)
    record("buckets", *bucket_check(curve, st, ka, timed, plain_ms, tag,
                                    "uniform draw"))
    s8 = s[:, torch.arange(n, device=device) % 8].contiguous()
    st8 = msm.sorted_streams(*digits.signed_digits(curve.fr, s8, c, W), c, m)
    # the run ends hi_b of both inputs against a plain count (each sorted
    # stream's keys <= b) before the bucket assembly reads them, and the
    # histogram of the sorted keys (long runs of one digit) exact
    for label, stx in (("uniform draw", st), ("8 pool scalars", st8)):
        ks = torch.sort(stx.keys.reshape(W, -1), dim=1).values
        if not torch.equal(stx.hi, torch.searchsorted(
                ks, torch.arange(1, D + 1, dtype=ks.dtype, device=device)
                .expand(W, D).contiguous(), right=True)):
            raise AssertionError(f"run ends ({curve.name}, {label}): hist "
                                 "and cumsum disagree with a plain count")
    hist_exact(hist, st8.keys.reshape(W, -1), D, "sorted keys, 8 pool "
               "scalars")
    a8 = phase_a.scan(curve, st8.keys, st8.sidx, px, py, D + 1, pts)
    err, ms8, plain8, ok, bnd = bucket_check(curve, st8, a8, timed, plain_ms,
                                             tag, "8 pool scalars")
    if not ok:
        raise AssertionError(f"buckets ({curve.name}, 8 pool scalars): "
                             "kernel disagrees with plain")
    ms8.update({"max_abs_err": err, "plain_ms": plain8, **bnd})
    res["buckets"]["long_runs"] = ms8      # the timer fills in its "ms"

    # 4. the weighted reduction of the bucket tables (its plan's launches
    #    against the plain decomposition, point-equal); the bound counts the
    #    function's work, two complete adds a bucket and the tables read
    #    once, not the combine's extra adds and doublings; each level is
    #    timed on its own inputs and a call's device ms is their sum
    N = W * D
    plan = reduce.wscan_plan(W, D, reduce.wscan_threads(curve, device))
    wscan_bound = bound(3 * fe * N + 3 * fe * W, imad(24 * N), IMAD_PER_S)
    # each level on its own: x (and p above level 0) read, P (and X below
    # the last level) written, two complete adds an element
    wscan_bound["launch_bounds_ms"] = [bound(
        3 * fe * W * (lv.E * (1 + (i > 0)) + lv.blocks * (
            2 if lv.blocks > 1 else 1)), imad(24 * W * lv.E),
        IMAD_PER_S)["bound_ms"] for i, lv in enumerate(plan)]
    kr = reduce.weighted_window_sum(curve, kb)
    pr = reduce.weighted_window_sum_plain(curve, kb)
    log(f"{tag} wscan: {len(plan)} launches {plan}")
    x, p, levels = ProjPoint(*(a.contiguous() for a in kb)), None, []
    for lv in plan:
        levels.append(lambda lv=lv, x=x, p=p: reduce.wscan_level(
            curve, lv, x, p))
        p, x = levels[-1]()
    # (projective representatives differ: max_abs_err of the affine words)
    record("wscan", max(word_err(a, b) for a, b in zip(
        cp.to_affine(curve, kr), cp.to_affine(curve, pr))),
           timed(lambda: reduce.weighted_window_sum(curve, kb), 10,
                 KERNEL_NAMES["wscan"], levels),
           plain_ms(lambda: reduce.weighted_window_sum_plain(curve, kb), 1),
           bool(cp.eq(curve, kr, pr).all()), wscan_bound)
    # 5. point ops on the bucket tables' shape (L, W, D) (where the bucket
    #    assembly's final add ran before buckets.cu, and the chunks' tables
    #    are summed above 2^20): an add, a mixed add of bases, a doubling
    #    and c doublings in one launch (the device Horner's window)
    q = ProjPoint(*(a.flip(-1).contiguous() for a in kb))
    idx = torch.arange(W * D, device=device).reshape(W, D) % px.shape[1]
    qa = AffinePoint(px[:, idx], py[:, idx])
    # bounds: (elements in + out) x fe bytes and the multiplies per element:
    # padd 6 + 3 words, 12M; pmadd 5 + 3, 11M; pdbl 3 + 3, 8M (6M + 2S) a
    # doubling
    variants = {}
    for op, kf, pf, args, fes, muls in (
            ("padd", point_kernels.padd, cp.add_plain, (kb, q), 9, 12),
            ("pmadd", point_kernels.pmadd, cp.madd_plain, (kb, qa), 8, 11),
            ("pdbl", point_kernels.pdbl, point_kernels.pdbl_plain, (kb,), 6,
             8),
            ("pdbl_c", lambda cv, p: point_kernels.pdbl(cv, p, c),
             lambda cv, p: point_kernels.pdbl_plain(cv, p, c), (kb,), 6,
             8 * c)):
        kr, pr = kf(curve, *args), pf(curve, *args)
        kname = f"{op.split('_')[0]}_kernel"
        v = timed(lambda kf=kf, args=args: kf(curve, *args), 20, (kname,))
        v.update(bound(fes * fe * N, imad(muls * N), IMAD_PER_S))
        v.update({"point_equal": bool(cp.eq(curve, kr, pr).all()),
                  "max_abs_err": max(word_err(a, b) for a, b in zip(kr, pr)),
                  "plain_ms": plain_ms(lambda pf=pf, args=args: pf(
                      curve, *args), 2 if op != "pdbl_c" else 1),
                  "elements": N, "k": c if op == "pdbl_c" else None})
        variants[op] = v
    log(f"{tag} point_ops on {N} elements (c = {c}): " + "; ".join(
        f"{op} batch {v['batch_ms']:.4f} ms, plain {v['plain_ms']} ms, bound "
        f"{v['bound_ms']:.4f} ({v['bound_by']}), max_abs_err "
        f"{v['max_abs_err']}" for op, v in variants.items()))
    res["point_ops_variants"] = variants
    bad = [op for op, v in variants.items() if not v["point_equal"]]
    if bad:
        raise AssertionError(f"point_ops {bad} ({curve.name}, {N} elements): "
                             "kernel disagrees with plain")
    # the library's record: padd's times and bound, every op's largest error
    p, summary = variants["padd"], {"batch_ms": variants["padd"]["batch_ms"]}
    timer.copy(p, summary)
    record("point_ops", max(v["max_abs_err"] for v in variants.values()),
           summary, p["plain_ms"], True,
           {k: p[k] for k in ("bound_ms", "bound_by")})
    return res


def hist_exact(hist, d, D: int, label: str) -> None:
    """Raise unless hist.hist_counts(d, D) equals the plain counts."""
    import torch
    if not torch.equal(hist.hist_counts(d, D), hist.hist_counts_plain(d, D)):
        raise AssertionError(f"hist ({label}, D = {D}): kernel disagrees "
                             "with plain")
    log(f"[kernels] hist ({label}, {tuple(d.shape)}, D = {D}): exact")


def bucket_check(curve, st, a, timed, plain_ms, tag: str, label: str):
    """Phase 3's bucket assembly: csrc/buckets.cu's two launches
    (assemble_buckets) against assemble_buckets_plain on the same phase-A
    outputs ``a``, point-equal (max_abs_err of the affine words), each
    launch timed on its own inputs.  The bound counts what this data needs:
    hi_b, the emission key at each run end and the emissions that are
    valid, the tail keys and the live tails read once, the tables written
    once; an add a live tail lane that continues a run and one a bucket
    with both parts.  Returns (max_abs_err, timing, plain ms, ok, bound),
    the bound with each launch's ("launch_bounds_ms": the tails launch
    reads the tails, and hi_b and the emission of each bucket with tails,
    and writes those buckets; the fill launch the rest) and the bound of
    the point-op launches the bucket assembly made before (a padd over the
    tails a round of the ceil(log2 m)-round scan, one over the tables)."""
    import torch
    from panda_tpu_torch.curves import point as cp
    from panda_tpu_torch.curves.point import ProjPoint
    from panda_tpu_torch.fields import mont
    from panda_tpu_torch.ops import msm
    ekeys, epts, tkeys, tpts = a
    W, S, m = st.keys.shape
    D, P = st.D, S * m
    fe = 4 * mont.n_words(curve.fp)
    imad = lambda adds: 12 * adds * cios_imads(fe // 4)   # noqa: E731
    kb = msm.assemble_buckets(curve, st, *a)
    pb = msm.assemble_buckets_plain(curve, st, *a)
    ok = bool(cp.eq(curve, kb, pb).all())
    err = max(word_err(x, y) for x, y in zip(cp.to_affine(curve, kb),
                                             cp.to_affine(curve, pb)))
    targets = torch.arange(1, D + 1, dtype=torch.int32, device=ekeys.device)
    slot = st.hi.clamp(0, P - 1)
    pos = (slot % S) * m + slot // S
    valid_i = (ekeys.reshape(W, P).gather(1, pos) == targets) & \
        (st.hi % S != 0)
    q = st.hi // S - 1
    valid_t = (tkeys.gather(1, q.clamp(0, m - 1)) == targets) & (q >= 0)
    n_i, n_t = int(valid_i.sum().item()), int(valid_t.sum().item())
    live = int(((tkeys >= 1) & (tkeys <= D)).sum().item())
    both = int((valid_i & valid_t).sum().item())
    bnd = bound(W * D * (8 + 4 + 3 * fe) + n_i * 3 * fe + W * m * 4 +
                live * 3 * fe, imad(live - n_t + both), IMAD_PER_S)
    bnd["launch_bounds_ms"] = [
        bound(W * m * 4 + live * 3 * fe + n_t * (8 + 4 + 3 * fe) +
              both * 3 * fe, imad(live - n_t + both), IMAD_PER_S)["bound_ms"],
        bound((W * D - n_t) * (8 + 4 + 4 + 3 * fe) + (n_i - both) * 3 * fe,
              0, IMAD_PER_S)["bound_ms"]]
    bnd["replaced_point_ops_bound_ms"] = sum(
        bound(9 * fe * N, imad(N), IMAD_PER_S)["bound_ms"]
        for N in [W * m] * (m - 1).bit_length() + [W * D])
    plan = msm.bucket_plan(W, m, msm.buckets_threads(curve, ekeys.device))
    out = ProjPoint(*(torch.empty_like(x) for x in kb))
    parts = [lambda fill=fill: msm.bucket_launch(curve, plan, st, *a, out,
                                                 fill)
             for fill in (False, True)]
    log(f"{tag} buckets ({label}): plan {plan}; {n_i} interior runs, "
        f"{n_t} buckets with tails, {live} live tail lanes, {both} final "
        f"adds; bound a launch {bnd['launch_bounds_ms']}; the point-op "
        f"launches it replaced: bound {bnd['replaced_point_ops_bound_ms']:.4f}"
        " ms a call")
    ms = timed(lambda: msm.assemble_buckets(curve, st, *a), 20,
               KERNEL_NAMES["buckets"], parts)
    return (err, ms, plain_ms(lambda: msm.assemble_buckets_plain(
        curve, st, *a), 1), ok, bnd)


def random_words(n: int, seed: int, top: int = 1 << 32):
    """(8, n) int32 words of random values whose top word is below ``top``
    (r >> 224 keeps them below r, 2r >> 224 below 2r)."""
    import torch
    g = np.random.default_rng(seed)
    w = g.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    w[7] %= top
    return torch.from_numpy(w.astype(np.uint32).view(np.int32))


def const_words(fr, value: int, device):
    """A plain integer as its canonical Montgomery (8,) words."""
    from panda_tpu_torch.fields import mont
    return mont.words_tensor(mont.ints_to_words(fr, [fr.to_wire_int(value)]),
                             device).reshape(-1)


# small_ntt's passes at the radix-2 engine's shapes: (key, log_n of the
# transform, the pass's index in ntt_pallas.pass_shapes(log_n), the leaf
# first): the 2^20 NTT's top pass (K = 256 with its T1 table, read as runs
# of 1), its middle and leaf passes (K = 64), and the 2^22 NTT's middle
# pass (K = 128, an odd log_k).
SMALL_NTT_PASSES = (("top", 20, 2), ("k64_t1", 20, 1), ("k64", 20, 0),
                    ("k128", 22, 1))


def ntt_kernel_checks(fr, log_n: int, device,
                      timer: DeviceTimes | None) -> dict:
    """Phase 3 for the NTT's kernels at the 2^log_n NTT's shapes, over the
    field ``fr``: fmul on (8, 2^log_n) (the top level's twiddle product: a
    DFT output < 2r times the table < r), the DFT at K = 32,
    nb = 2^(log_n - 5) (every pass of the four-step 2^20), forward and
    with the inverse's n^-1 scale and the canonical pass, the DFT at K = 4,
    nb = 2^log_n (the four-step 2^(log_n + 2) NTT's leaf), and the radix-2
    pass small_ntt at the radix-2 engine's shapes (SMALL_NTT_PASSES: the
    2^20 NTT's three passes and the 2^22 NTT's K = 128 middle pass, each
    in the layout the recursion hands it), each in the main path's
    configuration and in one with the inverse's scale, the canonical store
    and (given a T1 table) input words >= 2r reduced at load.  Kernel and
    plain version must give equal words.  Times (``timed``) at the main
    path's configuration (given a ``timer``, which fills in the device ms a
    launch) beside the batch time: small_ntt's entry is the 2^20 top pass,
    the others small_ntt_<key> with each launch's geometry (blocks, tiles,
    waves), the DFT's K = 4 entry dft_k4, and the torch._int_mm yardstick
    (the same M x K x N in signed int8, no reduction) is logged beside the
    DFT."""
    import torch
    from panda_tpu_torch.fields import mont
    from panda_tpu_torch.ops import fmul, ntt_fused, ntt_pallas
    res = {}
    n, r = 1 << log_n, fr.modulus
    # the stored values' bound: 2r, or r for BLS12-381 Fr (mont.canon),
    # whose fmul takes a < r and whose passes keep values below r
    below_r = r >> 224
    stored = below_r if mont.canon(fr) else (2 * r) >> 224
    tag = f"[kernels {fr.name}]"

    def check(name, pairs):
        errs = [word_err(k, p) for k, p in pairs]
        log(f"{tag} {name}: max_abs_err={max(errs)}")
        if not all(torch.equal(k, p) for k, p in pairs):
            raise AssertionError(f"{name} ({fr.name}): kernel disagrees with "
                                 "plain")
        return max(errs)

    def entry(name, err, kernel, plain, plain_reps, nbytes, ops, rate,
              kname=None):
        if timer is None:
            return
        res[name] = {"max_abs_err": err, "batch_ms": cuda_ms(kernel, 20),
                     "plain_ms": cuda_ms(plain, plain_reps),
                     **bound(nbytes, ops, rate), "library_ms": None}
        timer.add(kernel, 20, KERNEL_NAMES[kname or name], res[name])
        log(f"{tag} {name}: {res[name]}")

    a = random_words(n, 31, stored).to(device)                # < 2r (r)
    b = random_words(n, 32, below_r).to(device)               # < r
    err = check("fmul", [(fmul.fmul(fr, a, b, c), fmul.fmul_plain(fr, a, b, c))
                         for c in (False, True)])
    entry("fmul", err, lambda: fmul.fmul(fr, a, b),
          lambda: fmul.fmul_plain(fr, a, b), 2, 3 * 32 * n,
          n * MONT_MUL_IMADS, IMAD_PER_S)

    log_k, nb = 5, 1 << (log_n - 5)
    K = 1 << log_k
    x = random_words(K * nb, 33).reshape(8, K, nb).to(device)   # any < 2^256
    w = fr.root_of_unity(log_k)
    fwd = ntt_fused.dft_matrix(fr, log_k, w, 1, device)
    inv = ntt_fused.dft_matrix(fr, log_k, pow(w, -1, r), pow(n, -1, r),
                               device)
    err = check("dft", [(ntt_fused.dft_apply_fused(fr, x, log_k, m, c),
                         ntt_fused.dft_apply_fused_plain(fr, x, log_k, m, c))
                        for m, c in ((fwd, False), (inv, True))])
    D = 32 * K
    entry("dft", err,
          lambda x=x, log_k=log_k: ntt_fused.dft_apply_fused(fr, x, log_k,
                                                             fwd),
          lambda: ntt_fused.dft_apply_fused_plain(fr, x, log_k, fwd), 3,
          2 * 32 * K * nb + D * D, 2 * D * D * nb, INT8_OPS_PER_S)
    if timer is not None:
        a8 = torch.randint(-128, 128, (D, D), dtype=torch.int8,
                           device=device)
        b8 = torch.randint(-128, 128, (D, nb), dtype=torch.int8,
                           device=device)
        ym = cuda_ms(lambda: torch._int_mm(a8, b8), 20)
        res["dft"]["int_mm_ms"] = ym
        log(f"{tag} yardstick torch._int_mm ({D} x {D}) @ ({D} x {nb}) int8: "
            f"{ym:.4f} ms batch-timed")

    # the DFT at the four-step 2^(log_n + 2) NTT's leaf: K = 4
    log_k, nb = 2, 1 << log_n
    K, D = 1 << log_k, 32 << log_k
    x = random_words(K * nb, 37).reshape(8, K, nb).to(device)
    leaf = ntt_fused.dft_matrix(fr, log_k, fr.root_of_unity(log_k), 1, device)
    k4 = ntt_fused.dft_apply_fused(fr, x, log_k, leaf)
    err = check("dft K = 4", [(k4, ntt_fused.dft_apply_fused_plain(
        fr, x, log_k, leaf))])
    entry("dft_k4", err,
          lambda x=x, log_k=log_k: ntt_fused.dft_apply_fused(fr, x, log_k,
                                                             leaf),
          lambda: ntt_fused.dft_apply_fused_plain(fr, x, log_k, leaf), 3,
          2 * 32 * K * nb + D * D, 2 * D * D * nb, INT8_OPS_PER_S, "dft")

    errs, timing = [], {}
    for key, log_m, i in SMALL_NTT_PASSES:
        log_k, nb, batch, with_pre = ntt_pallas.pass_shapes(log_m)[i]
        K = 1 << log_k
        scale = const_words(fr, pow(1 << log_m, -1, r), device)
        tw = ntt_pallas.stage_twiddle_rows(fr, log_k, fr.root_of_unity(log_k),
                                           device)
        B = nb // (batch or nb)
        pre = random_words(K * B, 34, below_r).reshape(8, K, B).to(device) \
            if with_pre else None

        def view(words):
            """(8, K, nb) words as the pass reads them: natural, or the
            four-step inner output view (8, B, K, batch)."""
            x = words.reshape(8, K * nb).to(device)
            return x.reshape(8, B, K, batch) if batch else \
                x.reshape(8, K, nb)
        lazy = view(random_words(K * nb, 35, stored))
        wide = view(random_words(K * nb, 36))
        # (input, pre table, scale, reduce_in, canonical_out): the main
        # path's configuration first (the leaf reduces its words at load,
        # the top pass stores canonical words), then one with the inverse's
        # scale and the canonical store and, given a table, words >= 2r
        # reduced at load
        main = (lazy, pre, None, False, True) if key == "top" else \
            (wide, None, None, True, False) if not batch else \
            (lazy, pre, None, False, False)
        other = (wide, pre, scale, True, True) if with_pre else \
            (lazy, None, scale, False, True)
        for xi, *opts in (main, other):
            k = ntt_pallas.small_ntt_batch(fr, xi, log_k, tw, *opts)
            p = ntt_pallas.small_ntt_batch_plain(fr, xi, log_k, tw, *opts)
            errs.append(word_err(k, p))
            if not torch.equal(k, p):
                raise AssertionError(f"small_ntt ({fr.name}) {key}: kernel "
                                     "disagrees with plain")
        if timer is not None:
            xi, *opts = main
            muls = nb * ((log_k - 1) * K // 2 + (K if with_pre else 0))
            nbytes = 2 * 32 * K * nb + (32 * K * B if with_pre else 0)
            run = lambda xi=xi, log_k=log_k, tw=tw, opts=opts: (  # noqa
                ntt_pallas.small_ntt_batch(fr, xi, log_k, tw, *opts))
            geo = ntt_pallas.small_ntt_geometry(fr, log_k, nb, device)
            timing[key] = {
                "batch_ms": cuda_ms(run, 20),
                "plain_ms": cuda_ms(lambda: ntt_pallas.small_ntt_batch_plain(
                    fr, xi, log_k, tw, *opts), 2),
                **bound(nbytes, muls * MONT_MUL_IMADS, IMAD_PER_S),
                "geometry": geo, "waves": geo["tiles"] / geo["wave_blocks"]}
            timer.add(run, 20, KERNEL_NAMES["small_ntt"], timing[key])
            log(f"{tag} small_ntt {key}: K = {K}, nb = {nb}, "
                f"{'runs of ' + str(batch) if batch else 'natural'}"
                f"{', T1 table' if with_pre else ''}: {geo['blocks']} blocks "
                f"of {geo['threads']} ({geo['wave_blocks']} a wave), "
                f"{geo['tiles']} tiles of {geo['cols']} columns, "
                f"{timing[key]['waves']:.2f} waves of tiles, "
                f"r = {geo['r']}, {geo['rounds']} rounds; {timing[key]}")
    log(f"{tag} small_ntt: max_abs_err={max(errs)}")
    if timer is not None:
        res["small_ntt"] = timing["top"]
        res["small_ntt"].update({"max_abs_err": max(errs),
                                 "library_ms": None})
        for key, *_ in SMALL_NTT_PASSES[1:]:
            res[f"small_ntt_{key}"] = timing[key]
    return res


def gather_checks(device, timer: DeviceTimes) -> dict:
    """Phase 3 for dg3 at the gather probe's shapes: R = 8, 32, 256 and 1024
    with G = 2^22 / (128 R), tables and indices drawn as the probe draws
    them.  Kernel and plain version must give equal words.  Returns per R:
    max_abs_err, batch ms, plain ms, bound (the table, indices and output,
    4 bytes each a lookup), torch.gather's batch ms on int64 indices
    converted before the timing, the launch's geometry and, after the
    ``timer`` has filled in both device ms a launch (it takes its queue
    here), torch.gather's device ms and dg3's ratio to it."""
    import torch
    from panda_tpu_torch.tools import profile_gather4 as pg
    g = torch.Generator(device=device).manual_seed(4)
    by_r, gather = {}, {}
    for R in pg.DEPTHS:
        G = max(1, (1 << 22) // (R * pg.COLS))
        tab, idx = (torch.randint(0, hi, (G, R, pg.COLS), dtype=torch.int32,
                                  generator=g, device=device)
                    for hi in (1 << 31, R))
        k, p = pg.dg3(tab, idx), pg.dg3_plain(tab, idx)
        if not torch.equal(k, p):
            raise AssertionError(f"dg3 R = {R}: kernel disagrees with plain")
        idx64 = idx.long()
        row = by_r[R] = {
            "max_abs_err": word_err(k, p),
            "batch_ms": cuda_ms(lambda: pg.dg3(tab, idx), 20),
            "plain_ms": cuda_ms(lambda: pg.dg3_plain(tab, idx), 20),
            **bound(3 * 4 * G * R * pg.COLS, 0, IMAD_PER_S),
            "library_ms": cuda_ms(lambda: torch.gather(tab, 1, idx64), 20),
            "geometry": pg.dg3_geometry(G, R, device)}
        timer.add(lambda tab=tab, idx=idx: pg.dg3(tab, idx), 20,
                  KERNEL_NAMES["dg3"], row)
        # torch.gather's device ms a launch: every kernel record of its
        # batch (it launches one kernel a call)
        gather[R] = {}
        timer.add(lambda tab=tab, idx64=idx64: torch.gather(tab, 1, idx64),
                  20, ("",), gather[R])
        log(f"[kernels] dg3 R = {R}, G = {G}: {row}")
    timer.take()
    for R, row in by_r.items():
        row["library_device_ms"] = gather[R]["ms"]
        row["ratio_to_gather"] = row["ms"] / gather[R]["ms"]
        log(f"[kernels] dg3 R = {R}: {row['ms']:.4f} ms a launch against "
            f"torch.gather's {gather[R]['ms']:.4f} (device ms a launch; "
            f"{row['library_ms']:.4f} batch): ratio "
            f"{row['ratio_to_gather']:.3f}; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_ms'] / row['ms']:.2f} of it)")
    return by_r


def probe_layout_line(sl: dict, probe: list, phase_a_ms: float,
                      card: str) -> dict:
    """Phase 4, after the gather probe: 2^24 random lookups of a base point
    in phase A's layout, index_select of the same columns from the (8, n)
    x and y word tensors of the 2^20 MSM session (16 separate words a
    point), CUDA events over 5 calls; then the same with the indices cut
    below n / 8 (2 x 4 MiB of table, which the 50 MB L2 holds).  Printed
    beside the probe's R = 16 row gather (one 64-byte row a point) and
    phase A's device ms a launch at 2^20, which makes as many lookups.  A
    measurement only."""
    import torch
    px, py = sl["gm"].d_bases[0]
    n, ni = px.shape[1], 1 << 24
    g = torch.Generator(device=px.device).manual_seed(24)
    idx = torch.randint(0, n, (ni,), dtype=torch.int32, generator=g,
                        device=px.device)
    ms = cuda_ms(lambda: (px.index_select(1, idx), py.index_select(1, idx)),
                 5)
    low = idx & ((n >> 3) - 1)
    ms_l2 = cuda_ms(lambda: (px.index_select(1, low),
                             py.index_select(1, low)), 5)
    nbytes = 2 * px.numel() * 4 + ni * 4 + 2 * 8 * ni * 4
    row16 = next(r for r in probe if r["case"] == "row gather"
                 and r["R"] == 16)
    out = {"ms": ms, "bytes": nbytes, **bound(nbytes, 0, IMAD_PER_S),
           "ms_table_in_l2": ms_l2,
           "row_gather_r16_ms": row16["ms"],
           "row_gather_r16_bound_ms": row16["bound_ms"],
           "phase_a_2_20_ms": phase_a_ms}
    log(f"[probe] phase-A layout: {ni} lookups of a point from px, py "
        f"(8, {n}) int32: {ms:.4f} ms a call ({nbytes / ms / 1e6:.1f} GB/s, "
        f"bound {out['bound_ms']:.4f} ms, bytes; {ms_l2:.4f} ms with the "
        f"indices below {n >> 3}); row layout R = 16 "
        f"(n, 16) int32: {row16['ms']:.4f} ms (bound "
        f"{row16['bound_ms']:.4f}); phase A at 2^20: {phase_a_ms:.4f} ms a "
        f"launch for as many lookups, on {card}")
    return out


def kernel_ids() -> dict:
    """Every curve of the package (the JAX package's three, in the port's
    own copy) has a kernel id for each kernel family: its MSM curve id,
    its scalar field's digits id and NTT id; none raises
    NotImplementedError.  (Until the NTT kernels took BLS12-381 Fr, this
    phase checked that its NTT raised on the card.)"""
    from panda_tpu_torch.curves.config import CURVES
    from panda_tpu_torch.ops import _ext
    ids = {name: (_ext.kernel_field("phase_a", c, _ext.MSM_CURVES),
                  _ext.kernel_field("signed_digits", c.fr, _ext.MSM_FIELDS),
                  _ext.kernel_field("fmul", c.fr, _ext.NTT_FIELDS))
           for name, c in CURVES.items()}
    log(f"[kernels] ids (MSM curve, digits field, NTT field) a curve: {ids}")
    return ids


def ingest_check(curve, device) -> None:
    """The session's bases ingest (mont.reduce_wire, plain torch on the
    session's device) on the card equals it on the CPU for 48-byte (or
    32-byte) coordinates of any value below R, p and the top of R among
    them, and gives canonical words."""
    from panda_tpu_torch import PandaManager
    from panda_tpu_torch.fields import mont
    fp = curve.fp
    R, p = mont.radix(fp), fp.modulus
    g = random.Random(fp.n_bytes)
    vals = [0, p - 1, p, 2 * p + 1, R - 1] + [g.randrange(R)
                                              for _ in range(4091)]
    blob = b"".join(v.to_bytes(fp.n_bytes, "little") for v in vals)
    on_card = PandaManager.new(0, curve, device=device).ingest_bases(blob)
    on_cpu = PandaManager.new(0, curve, device="cpu").ingest_bases(blob)
    for a, b in zip(on_card, on_cpu):
        if not (a.device.type == "cuda" and a.shape == (mont.n_words(fp), 2048)
                and a.cpu().equal(b)):
            raise AssertionError(f"{curve.name}: bases ingest on the card "
                                 "differs from the CPU's")
    if not all(v < p for a in on_cpu for v in mont.words_to_ints(a)):
        raise AssertionError(f"{curve.name}: ingest left a word >= p")
    log(f"[slice {curve.name}] bases ingest of {len(vals) // 2} points "
        f"({fp.n_bytes}-byte coordinates) on the card equals the CPU's")


def slice_inputs(curve, log_n: int, device) -> dict:
    """A PandaManager on ``device`` with the cached bases of a pool-structured
    input at n = 2^log_n, the scalar bytes and the oracle's result blob."""
    from panda_tpu_torch import InitUnitType, PandaManager
    n = 1 << log_n
    t0 = time.perf_counter()
    bases, scalars, exp = pool_inputs(curve, n, 20260816)
    fp = curve.fp
    want = b"".join(fp.to_wire_int(v).to_bytes(fp.n_bytes, "little")
                    for v in ((*exp, 1) if exp is not None else (0, 1, 0)))
    log(f"[slice {curve.name} 2^{log_n}] inputs + oracle "
        f"{time.perf_counter() - t0:.1f} s")
    gm = PandaManager.init_all(0, InitUnitType.MSM, [bases], curve=curve,
                               device=device)
    gm.sync()
    return {"curve": curve, "log_n": log_n, "n": n, "gm": gm,
            "scalars": scalars, "bases": bases, "want": want}


def spread(ms: list) -> dict:
    return {"median_ms": statistics.median(ms), "min_ms": min(ms),
            "max_ms": max(ms)}


def slice_run(sl: dict, card: str, reps: int, entry: str = "cached") -> dict:
    """Phase 4 at one size: byte-API MSM, every call held to the oracle;
    host wall time of ``reps`` steady-state calls, with the calling
    thread's CPU time per call and the garbage collector's pauses, so a
    slow call shows whether the host thread worked, waited or collected.
    ``entry`` "cached" calls msm_with_cached_bases (BN254 through its alias
    msm_bn254_with_cached_bases), "alias" the curve's msm alias with the
    bases bytes (msm_bls12_377 / msm_bls12_381)."""
    import gc
    import torch
    from panda_tpu_torch.runtime import api
    gm, scalars, want, log_n = sl["gm"], sl["scalars"], sl["want"], sl["log_n"]
    curve = sl["curve"]
    if entry == "alias":
        alias = {"bls12_377": api.msm_bls12_377,
                 "bls12_381": api.msm_bls12_381}[curve.name]
        call = lambda: alias(gm, scalars, sl["bases"])    # noqa: E731
    elif curve.name == "bn254":
        call = lambda: api.msm_bn254_with_cached_bases(   # noqa: E731
            gm, scalars, 0)
    else:
        call = lambda: api.msm_with_cached_bases(gm, scalars, 0)  # noqa
    label = f"{'' if curve.name == 'bn254' else curve.name + ' '}" \
        f"2^{log_n}{' alias' if entry == 'alias' else ''}"
    t0 = time.perf_counter()
    blob = call()
    first = time.perf_counter() - t0
    if blob != want:
        raise AssertionError(f"MSM {label}: blob != oracle")
    times, cpu, gc_ms, gc_t0 = [], [], [0.0], [0.0]

    def on_gc(phase, _info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_t0[0]) * 1e3

    gc.callbacks.append(on_gc)
    try:
        for _ in range(reps):
            torch.cuda.synchronize()
            c0, t0 = time.thread_time(), time.perf_counter()
            blob = call()
            times.append((time.perf_counter() - t0) * 1e3)
            cpu.append((time.thread_time() - c0) * 1e3)
            if blob != want:
                raise AssertionError(f"MSM {label}: repeat blob != oracle")
    finally:
        gc.callbacks.remove(on_gc)
    s, sc = spread(times), spread(cpu)
    log(f"[slice {label}] oracle-exact; first call {first:.3f} s, steady "
        f"ms/call over {reps} calls: median {s['median_ms']:.2f}, min "
        f"{s['min_ms']:.2f}, max {s['max_ms']:.2f}; "
        f"{sl['n'] / s['median_ms'] * 1e3:.0f} points/s at the median on "
        f"{card}")
    log(f"[slice {label}] host thread CPU ms/call: median "
        f"{sc['median_ms']:.2f}, min {sc['min_ms']:.2f}, max "
        f"{sc['max_ms']:.2f}; garbage collection {gc_ms[0]:.2f} ms over "
        f"{reps} calls")
    return {"curve": curve.name, "entry": entry, "log_n": log_n,
            "first_s": first, **s,
            "points_per_s": sl["n"] / s["median_ms"] * 1e3, "calls_ms": times,
            "cpu_ms": cpu, "gc_ms": gc_ms[0]}


def window_sums(sl: dict):
    """(window sums (L, W) on the card, c) of a slice's byte-API inputs."""
    from panda_tpu_torch.ops import msm
    gm, curve = sl["gm"], sl["curve"]
    c = msm.window_bits(sl["log_n"], bits=curve.fr.bits)
    px, py = gm.d_bases[0]
    return msm.window_sums_fn(curve, c)(
        px, py, gm.ingest_scalars(sl["scalars"]), gm.point_major(0)), c


def point_api_path(sl: dict, sums, c: int) -> dict:
    """The point API on the card (point_kernels.pdbl / curves.point.add,
    kernel point_ops, which the MSM path runs only to sum chunks):
    msm.horner over the window sums ``sums`` of a slice's inputs, c
    doublings in one launch and one add a window (2W launches), held to
    msm.host_horner on the same sums and to the oracle's blob; host wall
    time and launches."""
    import torch
    from panda_tpu_torch.ops import _ext, msm
    gm, curve, log_n = sl["gm"], sl["curve"], sl["log_n"]
    W = sums.x.shape[1]
    before = _ext.launches["point_ops"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = msm.horner(curve, sums, c)
    got = affine_ints(curve, acc)
    ms = (time.perf_counter() - t0) * 1e3
    if got != msm.host_horner(curve, sums, c) or \
            gm.format_affine_result(got) != sl["want"]:
        raise AssertionError(f"point API Horner ({curve.name} 2^{log_n}): "
                             "result != host Horner / oracle")
    launched = _ext.launches["point_ops"] - before
    if launched != 2 * W:
        raise AssertionError(f"point API Horner ({curve.name} 2^{log_n}): "
                             f"{launched} point_ops launches, want {2 * W}")
    log(f"[point API {curve.name} 2^{log_n}] msm.horner over {W} window sums "
        f"on the card: {launched} point_ops launches, {ms:.3f} ms (host "
        "clock, the launches paced by the host); equal to host Horner and "
        "oracle")
    return {"curve": curve.name, "log_n": log_n, "windows": W, "c": c,
            "point_ops_launches": launched, "ms": ms}


def affine_ints(curve, pt):
    """A point (L,) on the card -> its affine (x, y) as plain ints, or None
    for the identity."""
    from panda_tpu_torch.curves import point as cp
    from panda_tpu_torch.fields import mont
    if bool(cp.is_identity(curve, pt)):
        return None
    p = curve.fp.modulus
    rinv = pow(mont.radix(curve.fp), -1, p)
    return tuple(mont.words_to_ints(a)[0] * rinv % p
                 for a in cp.to_affine(curve, pt))


def array_msm_path(sl: dict, card: str) -> dict:
    """The array-level msm.msm of a slice's cached bases and scalar words on
    the card (window sums as in the byte API, then msm.horner with the
    point_ops kernel): its point equals the oracle's; launches and host
    wall time of one call (its first)."""
    import torch
    from panda_tpu_torch.ops import _ext, msm
    gm, curve, log_n = sl["gm"], sl["curve"], sl["log_n"]
    px, py = gm.d_bases[0]
    s = gm.ingest_scalars(sl["scalars"])
    before = dict(_ext.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = msm.msm(curve, px, py, s)
    got = affine_ints(curve, q)
    ms = (time.perf_counter() - t0) * 1e3
    launched = {k: _ext.launches[k] - before[k] for k in before}
    if q.x.shape != (px.shape[0],) or \
            gm.format_affine_result(got) != sl["want"]:
        raise AssertionError(f"msm.msm ({curve.name} 2^{log_n}) != oracle")
    c = msm.window_bits(log_n, bits=curve.fr.bits)
    W = msm.signed_window_count(curve.fr.bits, c)
    if launched["point_ops"] != 2 * W + \
            chunked_launches(curve, sl["n"], 1)["point_ops"]:
        raise AssertionError(f"msm.msm ({curve.name} 2^{log_n}): "
                             f"{launched['point_ops']} point_ops launches")
    log(f"[array msm {curve.name} 2^{log_n}] msm.msm equals the oracle; "
        f"{ms:.3f} ms (host clock, one call); launches {launched} on "
        f"{card}")
    return {"curve": curve.name, "log_n": log_n, "ms": ms,
            "launches": launched}


def chunked_launches(curve, n: int, calls: int) -> dict:
    """The MSM kernels' launches in ``calls`` byte-API MSM calls of n
    points: a chunk of msm.CHUNK_N points (n at most) runs hist, phase A
    and the bucket assembly's two launches once a window group, the chunks'
    bucket tables are summed with chunks - 1 padd launches, and the
    weighted reduction is wscan's two launches; digits once."""
    from panda_tpu_torch.ops import msm
    c = msm.window_bits((n - 1).bit_length(), bits=curve.fr.bits)
    W = msm.signed_window_count(curve.fr.bits, c)
    size = min(n, msm.CHUNK_N)
    chunks = -(-n // size)
    runs = chunks * -(-W // msm._window_group_size(size, W))
    per = {"digits": 1,
           "hist": runs if 1 << (c - 1) >= msm._HIST_MIN_D else 0,
           "phase_a": runs, "buckets": 2 * runs, "point_ops": chunks - 1,
           "wscan": 2}
    return {k: v * calls for k, v in per.items()}


def big_msm_path(sl: dict, card: str, reps: int) -> dict:
    """Phase 4 above 2^20 points: slice_run (a first call, then ``reps``
    timed ones, each blob held to the oracle), counted on its own; the
    launches must be exactly chunked_launches'.  Then, not counted, the
    window sums' batch ms from CUDA events (scalars on the card, a
    warm-up and 2 calls): the call's device part."""
    from panda_tpu_torch.ops import msm
    curve, gm = sl["curve"], sl["gm"]
    res, counts = counted(MSM_KERNELS + POINT_API_KERNELS,
                          lambda: slice_run(sl, card, reps))
    want = chunked_launches(curve, sl["n"], reps + 1)
    if {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"MSM {curve.name} 2^{sl['log_n']}: "
                             f"launches {counts}, want {want}")
    fn = msm.window_sums_fn(curve, msm.window_bits(sl["log_n"],
                                                   bits=curve.fr.bits))
    s = gm.ingest_scalars(sl["scalars"])
    dev = cuda_ms(lambda: fn(*gm.d_bases[0], s, gm.point_major(0)), 2)
    log(f"[slice {curve.name} 2^{sl['log_n']}] launches over {reps + 1} "
        f"calls equal the chunked path's: {want}; window sums {dev:.3f} ms "
        f"on the device (CUDA events, 2 calls) on {card}")
    return dict(res, launches=counts, window_sums_device_ms=dev)


def chunk_vs_groups(sl: dict, card: str, reps: int) -> dict:
    """A measurement only: BN254 above 2^20 with the default chunks
    (msm.CHUNK_N) against window groups alone (CHUNK_N = n: one chunk,
    _PHASE_A_BUDGET / n windows a phase-A launch).  Per mode: byte-API
    host ms (calls in the order chunked, groups, groups, chunked, each
    blob held to the oracle), the window sums' batch ms from CUDA events
    (scalars on the card, a warm-up and ``reps`` calls), the peak device
    memory of one call above the session's, and one call's launches."""
    import torch
    from panda_tpu_torch.ops import _ext, msm
    from panda_tpu_torch.runtime import api
    gm, curve, n = sl["gm"], sl["curve"], sl["n"]
    c = msm.window_bits(sl["log_n"], bits=curve.fr.bits)
    px, py = gm.d_bases[0]
    pts = gm.point_major(0)
    s = gm.ingest_scalars(sl["scalars"])
    fn = msm.window_sums_fn(curve, c)
    chunk = {"chunked": msm.CHUNK_N, "groups": n}
    out = {mode: {"calls_ms": []} for mode in chunk}
    default = msm.CHUNK_N
    try:
        for mode in ("chunked", "groups", "groups", "chunked"):
            msm.CHUNK_N = chunk[mode]
            torch.cuda.synchronize()
            before = dict(_ext.launches)
            t0 = time.perf_counter()
            blob = api.msm_bn254_with_cached_bases(gm, sl["scalars"], 0)
            out[mode]["calls_ms"].append((time.perf_counter() - t0) * 1e3)
            out[mode]["launches"] = {k: _ext.launches[k] - before[k]
                                     for k in before if _ext.launches[k]
                                     - before[k]}
            if blob != sl["want"]:
                raise AssertionError(f"MSM 2^{sl['log_n']} ({mode}): blob "
                                     "!= oracle")
        for mode, size in chunk.items():
            msm.CHUNK_N = size
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(gm.device)
            torch.cuda.reset_peak_memory_stats(gm.device)
            fn(px, py, s, pts)
            torch.cuda.synchronize()
            out[mode]["peak_gib"] = (torch.cuda.max_memory_allocated(
                gm.device) - base) / 2**30
            out[mode]["device_ms"] = cuda_ms(lambda: fn(px, py, s, pts), reps)
            out[mode]["median_ms"] = statistics.median(out[mode]["calls_ms"])
    finally:
        msm.CHUNK_N = default
    log(f"[chunks vs groups {curve.name} 2^{sl['log_n']}] " + "; ".join(
        f"{mode}: byte API {v['calls_ms']} ms, window sums "
        f"{v['device_ms']:.3f} ms (CUDA events, {reps} calls), peak "
        f"{v['peak_gib']:.2f} GiB above the session, launches a call "
        f"{v['launches']}"
        for mode, v in out.items()) + f" on {card}")
    return {"log_n": sl["log_n"], **out}


def point_helpers_path(curve, device, card) -> dict:
    """fold_sum, total_sum and scalar_mul (curves.point, ops.reduce; kernel
    point_ops) on 2^16 points drawn from 1024 random ones, on the card:
    the sums equal the host's big-integer sum (the oracle MSM of the draw
    counts), scalar_mul of a full-width scalar equals k P for each point
    (cp.eq against the host's multiples); launches and host ms each."""
    import torch
    from panda_tpu_torch.curves import point as cp
    from panda_tpu_torch.curves.point import AffinePoint
    from panda_tpu_torch.fields import mont
    from panda_tpu_torch.ops import _ext
    from panda_tpu_torch.ops import reduce as red
    from panda_tpu_torch.reference import curve_ref
    fp, fr = curve.fp, curve.fr
    n = 1 << 16
    pool = pool_points(curve, 20261017, 1024)
    idx = torch.from_numpy(np.random.default_rng(16).integers(1024, size=n))

    def on_card(pts):
        """Affine int points -> (L, len) Montgomery words on the card."""
        return [mont.words_tensor(mont.ints_to_words(
            fp, [fp.to_wire_int(q[i]) for q in pts]), device)
            for i in (0, 1)]

    px, py = (t[:, idx.to(device)] for t in on_card(pool))
    p = cp.from_affine(curve, AffinePoint(px, py))
    total = curve_ref.msm_oracle(curve, pool, torch.bincount(
        idx, minlength=1024).tolist())
    k = random.Random(16).randrange(fr.modulus)
    kw = torch.from_numpy(mont.ints_to_words(fr, [k])[:, 0].view(np.int32))
    kx, ky = (t[:, idx.to(device)] for t in on_card(
        [curve_ref.ec_mul(curve, q, k) for q in pool]))
    res = {}
    for name, run, want in (
            ("fold_sum", lambda: cp.fold_sum(curve, p), None),
            ("total_sum", lambda: red.total_sum(curve, p), None),
            ("scalar_mul", lambda: cp.scalar_mul(curve, p, kw),
             cp.from_affine(curve, AffinePoint(kx, ky)))):
        before = _ext.launches["point_ops"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if want is None:
            ok = affine_ints(curve, got) == total
        else:
            ok = bool(cp.eq(curve, got, want).all())
        if not ok:
            raise AssertionError(f"{name} ({curve.name}, 2^16 points) on the "
                                 "card != host big integers")
        res[name] = {"ms": ms,
                     "point_ops_launches": _ext.launches["point_ops"] - before}
    log(f"[point helpers {curve.name} 2^16] fold_sum, total_sum and "
        f"scalar_mul equal the host's big integers; {res} on {card}")
    return res


def msm_host_path(device, card: str) -> list:
    """api.msm_host for the three curves at 2^12 with both coordinate
    types: the native library's blob equals the one the smoke computes
    from the oracle's affine (x, y) and the blob's own Z (Jacobian
    (x Z^2, y Z^3, Z), projective (x Z, y Z, Z)); host ms a call."""
    from panda_tpu_torch import PandaManager
    from panda_tpu_torch.curves.config import CURVES
    from panda_tpu_torch.runtime import api
    from panda_tpu_torch.runtime.manager import ResultCoordinateType
    out = []
    for name, curve in CURVES.items():
        fp = curve.fp
        bases, scalars, exp = pool_inputs(curve, 1 << 12, 20260816)
        if exp is None:
            raise AssertionError("msm_host gate: the oracle is the identity")
        gm = PandaManager.new(0, curve, device=device)
        for coords in ResultCoordinateType:
            gm.set_config(coords)
            t0 = time.perf_counter()
            blob = api.msm_host(gm, scalars, bases)
            ms = (time.perf_counter() - t0) * 1e3
            nb, p = fp.n_bytes, fp.modulus
            z = fp.from_wire_int(int.from_bytes(blob[2 * nb:], "little"))
            ex, ey = (z * z, z * z * z) if coords == 0 else (z, z)
            want = b"".join(fp.to_wire_int(v % p).to_bytes(nb, "little")
                            for v in (exp[0] * ex, exp[1] * ey, z))
            if blob != want:
                raise AssertionError(f"msm_host {name} {coords.name}: bytes "
                                     "!= the oracle's")
            out.append({"curve": name, "coords": coords.name, "ms": ms})
    log("[msm_host 2^12] every blob equals the oracle's (both coordinate "
        "types); host ms a call: " + ", ".join(
            f"{r['curve']} {r['coords'].lower()} {r['ms']:.3f}" for r in out)
        + f" on {card}")
    return out


def zero_root_path(device) -> dict:
    """ntt_v1 with a zero root at 2^10 (BN254) under auto, mxu and pallas
    gives the stagewise engine's bytes (jnp) on the card: every impl takes
    the stagewise engine for it."""
    from panda_tpu_torch import InitUnitType, PandaManager
    from panda_tpu_torch.curves.config import BN254
    from panda_tpu_torch.runtime import api
    data, zero = ntt_case(BN254.fr, 10, 1010)["data"], bytes(32)
    gm = PandaManager.init_all(0, InitUnitType.NTT, device=device)
    with ntt_engine("jnp"):
        want = api.ntt_v1(gm, data, 10, zero)
    for impl in ("auto", "mxu", "pallas"):
        with ntt_engine(impl):
            if api.ntt_v1(gm, data, 10, zero) != want:
                raise AssertionError(f"ntt_v1 zero root 2^10 ({impl}) != "
                                     "the stagewise engine's bytes")
    log("[ntt zero root 2^10] auto, mxu and pallas give the stagewise "
        "engine's bytes")
    return {"log_n": 10, "impls": ["auto", "mxu", "pallas"]}


# The sharded NTT's kernels by local engine (the sharded MSMs launch
# MSM_KERNELS, and point_ops where ranks' sums are folded).
SHARDED_NTT_KERNELS = {"mxu": ("fmul", "dft"), "jnp": ("fmul",)}
SHARDED_SEED = 20260816          # phase 4's: its point pools are made


def sharded_msm_case(curve, log_n: int, mode: str, mesh, tmp,
                     device) -> tuple:
    """A sharded MSM case of ``mode`` on pool-structured inputs at 2^log_n
    (written to files under ``tmp`` for the ranks) and what its every rank
    must return: the pool-aggregated oracle's point, whose blob the
    single-device byte API returns too."""
    from panda_tpu_torch import PandaManager
    from panda_tpu_torch.ops import msm
    from panda_tpu_torch.runtime import api
    bases, scalars, exp = pool_inputs(curve, 1 << log_n, SHARDED_SEED)
    gm = PandaManager.new(0, curve, device=device)
    blob = api.msm(gm, scalars, bases)
    if blob != gm.format_affine_result(exp):
        raise AssertionError(f"{curve.name} 2^{log_n}: single-device blob "
                             "!= oracle")
    tag = f"{curve.name}_{mode}_{log_n}"
    paths = {}
    for name, data in (("bases", bases), ("scalars", scalars)):
        paths[name] = os.path.join(tmp, f"{tag}.{name}")
        with open(paths[name], "wb") as f:
            f.write(data)
    c = msm.window_bits(log_n, bits=curve.fr.bits)
    case = {"op": "msm", "mode": mode, "curve": curve.name, "c": c,
            "mesh": mesh, "reps": 3, **paths}
    folds = mode != "windows" and mesh[0][0] > 1      # padd over the ranks
    return case, {"label": f"{curve.name} MSM {mode} 2^{log_n}",
                  "want": exp,
                  "kernels": MSM_KERNELS + (("point_ops",) if folds else ())}


def sharded_ntt_case(fr, log_n: int, engine: str, inverse: bool, mesh,
                     tmp, device) -> tuple:
    """A sharded NTT case and the single-device run_ntt's bytes (the same
    engine, on the card) that its ranks' chunks must join to."""
    from panda_tpu_torch.fields import mont
    from panda_tpu_torch.ops import ntt as ntt_ops
    data = ntt_case(fr, log_n, SHARDED_SEED + log_n)["data"]
    x = mont.bytes_to_tensor(fr, data, device)
    want = mont.tensor_to_bytes(ntt_ops.run_ntt(
        fr, x, ntt_ops.make_tables(fr, log_n), inverse, impl=engine))
    path = os.path.join(tmp, f"{fr.name}_{engine}_{log_n}_{int(inverse)}")
    with open(path, "wb") as f:
        f.write(data)
    curve = {"bn254_fr": "bn254", "bls12_377_fr": "bls12_377",
             "bls12_381_fr": "bls12_381"}[fr.name]
    case = {"op": "ntt", "curve": curve, "log_n": log_n, "engine": engine,
            "inverse": inverse, "data": path, "mesh": mesh, "reps": 3}
    return case, {"label": f"{fr.name} NTT {engine}"
                           f"{' inverse' if inverse else ''} 2^{log_n}",
                  "want": want, "kernels": SHARDED_NTT_KERNELS[engine],
                  "absent": ("dft", "small_ntt") if engine == "jnp" else ()}


def check_sharded(cases, expect, ranks, card: str, world: str) -> list:
    """Every rank's result against its case's reference, each rank's
    launches of its path's kernels, and the median of its timed calls."""
    from panda_tpu_torch.fields import mont
    rows = []
    for i, (case, exp) in enumerate(zip(cases, expect)):
        res = [r[i] for r in ranks]
        if case["op"] == "msm":
            bad = [r for r, x in enumerate(res) if x["result"] != exp["want"]]
        else:
            import torch
            joined = mont.tensor_to_bytes(torch.cat(
                [x["result"] for x in res], dim=1))
            bad = [] if joined == exp["want"] else list(range(len(res)))
        if bad:
            raise AssertionError(f"{world} {exp['label']}: ranks {bad} "
                                 "differ from the reference")
        for r, x in enumerate(res):
            dead = [k for k in exp["kernels"] if x["launches"][k] == 0]
            stray = [k for k in exp.get("absent", ()) if x["launches"][k]]
            if dead or stray:
                raise AssertionError(f"{world} {exp['label']} rank {r}: "
                                     f"never launched {dead}, launched "
                                     f"{stray}: {x['launches']}")
        med = [statistics.median(x["ms"]) for x in res]
        launches = {k: v for k, v in res[0]["launches"].items() if v}
        rows.append({"label": exp["label"], "world": world,
                     "median_ms_by_rank": med, "launches_rank0": launches,
                     "launches_by_rank": [x["launches"] for x in res]})
        log(f"[sharded {world}] {exp['label']}: every rank equals the "
            f"{'oracle and the single-device blob' if case['op'] == 'msm' else 'single-device run_ntt bytes'}"
            f"; rank 0 launches {launches}; median ms of 3 calls by rank "
            f"{[round(m, 2) for m in med]} on {card}")
    return rows


NATIVE_CURVES = ("bn254", "bls12_381")
NATIVE_MSM_KERNELS = ("digits", "hist", "phase_a", "buckets", "wscan")
NATIVE_NTT_KERNELS = ("fmul", "dft")


def native_caller_path(device, card: str) -> dict:
    """The native caller: ``panda_tpu_torch.tools.native_engine_check`` in
    a process of its own, which imports no torch (no CUDA context) and
    reaches the card only through the port's libpanda_host.so and the
    engine worker it starts (execution target 1), as a Rust prover would.
    For BN254 and BLS12-381: the MSM at 2^16 by cached bases and scalars
    indices and by cached bases with fresh scalar bytes equal to the
    pool-aggregated oracle, NTT, INTT and ntt_v1 (w^3) at 2^12 equal to
    ntt_ref, and on the host target set_config(1), device_count() and
    ntt_host.  Every comparison must hold; each worker must add one
    compute app to nvidia-smi's list while it lives (nvidia-smi on this
    machine shows every process as pid 1, so the worker is told by the
    count) and return, call by call, the bytes (by sha256) and launch the
    kernels that the same call returns and launches in this process."""
    from panda_tpu_torch import PandaManager
    from panda_tpu_torch.curves.config import CURVES
    from panda_tpu_torch.ops import _ext
    from panda_tpu_torch.runtime import api
    from panda_tpu_torch.tools import native_engine_check as nec

    def count(fn):
        _ext.reset_counts()
        out = fn()
        return out, {"launches": dict(_ext.launches),
                     "sha256": hashlib.sha256(out).hexdigest()}

    log_n, ntt_log_n = 16, 12
    here = {}
    for name in NATIVE_CURVES:
        cv = CURVES[name]
        case = nec.msm_case(cv, log_n, oracle=False)
        nc = nec.ntt_case(cv.fr, ntt_log_n)
        gm = PandaManager.new(0, cv, device=device)
        row = here[name] = {}
        for call in ("msm_cached", "msm_fresh"):
            row[call] = count(lambda: api.msm(gm, case["scalars"],
                                              case["bases"]))[1]
        y, row["ntt"] = count(lambda: api.ntt(gm, nc["data"], ntt_log_n))
        row["intt"] = count(lambda: api.intt(gm, y, ntt_log_n))[1]
        row["ntt_v1"] = count(lambda: api.ntt_v1(gm, nc["data"], ntt_log_n,
                                                 nc["omega"]))[1]
        gm.deinit()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PANDA_WORKER_PYTHON=sys.executable)
    for var in ("PANDA_WORKER_DEVICE", "PANDA_WORKER_LAUNCHES"):
        env.pop(var, None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "panda_tpu_torch.tools.native_engine_check",
         "--log-n", str(log_n)], cwd=root, env=env, capture_output=True,
        text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"native check: rc {proc.returncode}\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    bad = [c for c in res["checks"] if not c["ok"]]
    if (not res["ok"] or bad or res["foreign_modules"]
            or res["ntt_log_n"] != ntt_log_n):
        raise AssertionError(f"native check: failed {bad}, modules "
                             f"{res['foreign_modules']}")
    for name in NATIVE_CURVES:
        row = res["engine"][name]
        before, during = row["compute_apps"]
        if len(during) != len(before) + 1:
            raise AssertionError(f"native check {name}: nvidia-smi compute "
                                 f"apps {before} before, {during} while the "
                                 "worker lived")
        for call, want in here[name].items():
            kernels = NATIVE_MSM_KERNELS if call.startswith("msm") else \
                NATIVE_NTT_KERNELS
            got = {"launches": row["launches"][call],
                   "sha256": row["sha256"][call]}
            if got != want or not all(want["launches"][k] for k in kernels):
                raise AssertionError(f"native check {name} {call}: worker "
                                     f"{got}, in this process {want}")
        fired = {call: {k: v for k, v in c.items() if v}
                 for call, c in row["launches"].items()}
        ms = {call: [round(t, 2) for t in v] for call, v in row["ms"].items()}
        log(f"[native] {name}: {len(res['checks']) // len(NATIVE_CURVES)} "
            "comparisons true in a process that imports no torch; the "
            f"worker held a CUDA context (nvidia-smi compute apps {before} "
            f"-> {during}); its bytes (sha256) and launches equal this "
            "process's call by call: "
            f"{fired}; start and ping {row['warmup_s']:.2f} s; MSM "
            f"2^{log_n} ms a call through the pipe, cached bases and scalars "
            f"{ms['msm_cached']}, cached bases and fresh scalars "
            f"{ms['msm_fresh']}; NTT / INTT / ntt_v1 2^{ntt_log_n} ms "
            f"{ms['ntt'] + ms['intt'] + ms['ntt_v1']} on {card}")
    log(f"[native] the check took {secs:.1f} s ({res['seconds']:.1f} s in "
        "its process after imports)")
    return dict(res, here=here, seconds_total=secs)


def sharded_paths(device, card: str) -> dict:
    """The multi-rank paths and the native caller.  Four gloo ranks share
    cuda:0 (the machine has one card): the points-sharded MSM at 2^22 and
    the windows-sharded at 2^20 (BN254), the 2 x 2 MSM at 2^22, BLS12-381
    points-sharded at 2^20, the sharded NTT (mxu) at 2^22 forward and
    inverse and stagewise (jnp) at 2^12 for BN254 Fr, and mxu at 2^20 for
    BLS12-381 Fr; then one NCCL rank (points-sharded MSM and NTT at 2^20),
    the dry runs on 4 and 1 ranks, and the native caller's check.  Times
    of four ranks time-sharing one card are not a scaling figure."""
    import tempfile
    import torch
    from panda_tpu_torch import PandaManager, entry
    from panda_tpu_torch.curves import point as cp
    from panda_tpu_torch.curves.config import BLS12_381, BN254
    from panda_tpu_torch.ops import msm
    from panda_tpu_torch.parallel import cluster

    def release(what: str) -> None:
        """Give the caching allocator's free blocks back before ranks
        start: the ranks share the card with this process's sessions."""
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(device)
        log(f"[sharded] before {what}: this process holds "
            f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB, "
            f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free")

    t0 = time.perf_counter()
    # padded windows: a block of zero digits sums to the identity on the card
    bases = pool_inputs(BN254, 1 << 16, SHARDED_SEED, oracle=False)[0]
    px, py = PandaManager.new(0, BN254, device=device).ingest_bases(bases)
    zeros = torch.zeros((4, 1 << 16), dtype=torch.int32, device=device)
    if not bool(cp.is_identity(BN254, msm.window_sums(
            BN254, px, py, zeros, zeros.bool(), 16)).all()):
        raise AssertionError("zero-digit windows: sums are not the identity")
    log("[sharded] 4 windows of zero digits at 2^16 sum to the identity on "
        "the card (the windows-sharded padding)")

    one_d, two_d = ((4,), ("points",)), ((2, 2), ("points", "windows"))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        built = [
            sharded_msm_case(BN254, 22, "points", one_d, tmp, device),
            sharded_msm_case(BN254, 20, "windows", one_d, tmp, device),
            sharded_msm_case(BN254, 22, "2d", two_d, tmp, device),
            sharded_msm_case(BLS12_381, 20, "points", one_d, tmp, device),
            sharded_ntt_case(BN254.fr, 22, "mxu", False, one_d, tmp, device),
            sharded_ntt_case(BN254.fr, 22, "mxu", True, one_d, tmp, device),
            sharded_ntt_case(BN254.fr, 12, "jnp", False, one_d, tmp, device),
            sharded_ntt_case(BN254.fr, 12, "jnp", True, one_d, tmp, device),
            sharded_ntt_case(BLS12_381.fr, 20, "mxu", False, one_d, tmp,
                             device)]
        cases, expect = zip(*built)
        log(f"[sharded] inputs and references {time.perf_counter() - t0:.1f}"
            " s")
        release("4 gloo ranks")
        t1 = time.perf_counter()
        ranks = cluster.spawn(entry.sharded_cases, 4, list(cases),
                              backend="gloo", device="cuda")
        out["gloo_4"] = check_sharded(cases, expect, ranks, card,
                                      "4 gloo ranks on cuda:0")
        log(f"[sharded] 4 gloo ranks: {time.perf_counter() - t1:.1f} s")

        t1 = time.perf_counter()
        one = ((1,), ("points",))
        built = [sharded_msm_case(BN254, 20, "points", one, tmp, device),
                 sharded_ntt_case(BN254.fr, 20, "mxu", False, one, tmp,
                                  device)]
        cases, expect = zip(*built)
        release("1 NCCL rank")
        ranks = cluster.spawn(entry.sharded_cases, 1, list(cases),
                              backend="nccl", device="cuda")
        out["nccl_1"] = check_sharded(cases, expect, ranks, card,
                                      "1 NCCL rank")
        log(f"[sharded] 1 NCCL rank: {time.perf_counter() - t1:.1f} s")

    for n in (4, 1):
        t1 = time.perf_counter()
        entry.dryrun_multichip(n)
        log(f"[sharded] dryrun_multichip({n}) on the card: "
            f"{time.perf_counter() - t1:.1f} s")
    out["native"] = native_caller_path(device, card)
    log(f"[sharded] phase took {time.perf_counter() - t0:.1f} s")
    return out


STAGES = ("ingest: bytes to words (host)", "ingest: copy to device",
          "digits kernel", "chunk digits (contiguous columns)",
          "sort + run ends (hist kernel)", "phase A kernel",
          "bucket assembly", "chunk tables add (padd kernel)",
          "weighted reduction", "host Horner + blob")


def stage_breakdown(curve, sl: dict, reps: int) -> dict:
    """Phase 5: the byte-API call of phase 4 run stage by stage, with a
    device synchronise around each stage (host clock).  The stages call
    the functions api._msm_run reaches, in its order (msm.window_sums'
    chunks and window groups included); the result is held to the oracle.
    Returns per-stage {median_ms, min_ms, max_ms} over ``reps`` calls and
    the kernel launches of one call."""
    import torch
    from panda_tpu_torch.curves import point as cp
    from panda_tpu_torch.curves.point import ProjPoint
    from panda_tpu_torch.fields import mont
    from panda_tpu_torch.ops import _ext, msm, phase_a
    from panda_tpu_torch.ops import reduce as red
    gm, log_n, n = sl["gm"], sl["log_n"], sl["n"]
    px, py = gm.d_bases[0]
    pts = gm.point_major(0)
    c = msm.window_bits(log_n, bits=curve.fr.bits)
    W = msm.signed_window_count(curve.fr.bits, c)
    size = min(n, msm.CHUNK_N)
    wg = msm._window_group_size(size, W)
    m = msm.default_lanes(size, wg, phase_a.resident_threads(curve,
                                                             gm.device))
    if W % wg:
        raise AssertionError("stage breakdown: padded window group")
    rows = {k: [] for k in STAGES}
    for _ in range(reps):
        _ext.reset_counts()
        cur = dict.fromkeys(STAGES, 0.0)

        def timed(stage, fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            cur[stage] += (time.perf_counter() - t0) * 1e3
            return out

        w = timed(STAGES[0], mont.bytes_to_words, curve.fr, sl["scalars"])
        s = timed(STAGES[1], mont.words_tensor, w, gm.device)
        mags, negs = timed(STAGES[2], msm.signed_digit_arrays, curve.fr, s, c)
        acc = None
        for lo in range(0, n, size):
            at = min(lo, n - size)
            d, sg = (timed(STAGES[3], msm._chunk_columns, a, lo, size)
                     for a in (mags, negs))
            parts = []
            for g in range(0, W, wg):
                st = timed(STAGES[4], msm.sorted_streams, d[g:g + wg],
                           sg[g:g + wg], c, m)
                em = timed(STAGES[5], phase_a.scan, curve, st.keys, st.sidx,
                           px[:, at:at + size], py[:, at:at + size],
                           st.D + 1, None if pts is None
                           else pts[at:at + size])
                parts.append(timed(STAGES[6], msm.assemble_buckets, curve,
                                   st, *em))
            part = ProjPoint(*(torch.cat([p[i] for p in parts], dim=1)
                               for i in range(3)))
            acc = part if acc is None else timed(STAGES[7], cp.add, curve,
                                                 acc, part)
        sums = timed(STAGES[8], red.weighted_window_sum, curve, acc)
        blob = timed(STAGES[9], lambda: gm.format_affine_result(
            msm.host_horner(curve, sums, c)))
        if blob != sl["want"]:
            raise AssertionError(f"stage breakdown {curve.name} 2^{log_n}: "
                                 "blob != oracle")
        for k in STAGES:
            rows[k].append(cur[k])
    totals = [sum(rows[k][i] for k in STAGES) for i in range(reps)]
    out = {k: spread(v) for k, v in rows.items()}
    out["total"] = spread(totals)
    log(f"[stages {curve.name} 2^{log_n}] c={c} W={W} chunks={-(-n // size)} "
        f"groups={W // wg} lanes={m}; ms per call over {reps} calls, "
        "synchronised stages (median / min / max):")
    for k, v in out.items():
        log(f"  {k:<34} {v['median_ms']:9.3f} {v['min_ms']:9.3f} "
            f"{v['max_ms']:9.3f}")
    log(f"  launches in one call: {dict(_ext.launches)}")
    return {"curve": curve.name, "log_n": log_n, "stages": out,
            "launches": dict(_ext.launches)}


def device_busy(calls) -> list:
    """Phase 6: byte-API calls, each (label, call, wanted bytes, unprofiled
    median ms of phase 4), in one torch.profiler session, each in its own
    range.  Busy time is the union of the device intervals within a call's
    range (kernels and copies; the profiler's own buffer requests left
    out); the share is given over the call's wall time under the profiler
    and over the unprofiled median.  Per kernel library: its launches in
    the call (the launch counters) and their device ms in all.  A call
    whose range holds no device record (a session at times loses its
    first records, as DeviceTimes says) runs again in a new session, up
    to DeviceTimes.RETRIES times, and the retry is logged."""
    import torch
    from torch.autograd import DeviceType
    from panda_tpu_torch.ops import _ext

    def job(call, st: dict):
        def run():
            before = dict(_ext.launches)
            t0 = time.perf_counter()
            blob = call()
            torch.cuda.synchronize()
            st.update(wall=(time.perf_counter() - t0) * 1e3,
                      launched={k: _ext.launches[k] - before[k]
                                for k in before})
            return blob
        return run

    names = [f"chip_smoke call {label}" for label, *_ in calls]
    done, todo = {}, list(range(len(calls)))
    for attempt in range(DeviceTimes.RETRIES + 1):
        stats = [{} for _ in todo]
        blobs, events, ranges = profile_ranges(
            [(names[i], job(calls[i][1], st)) for i, st in zip(todo, stats)])
        for i, blob, st in zip(todo, blobs, stats):
            if blob != calls[i][2]:
                raise AssertionError(f"profiled call {calls[i][0]}: wrong "
                                     "bytes")
            rng = ranges[names[i]]
            dev = [e for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.name not in names
                   and "Activity Buffer" not in e.name
                   and rng.start <= (e.time_range.start
                                     + e.time_range.end) / 2 <= rng.end]
            busy, end = 0.0, None
            for a, b in sorted((e.time_range.start, e.time_range.end)
                               for e in dev):    # union of intervals, in us
                if end is None or a > end:
                    busy += b - a
                    end = b
                elif b > end:
                    busy += b - end
                    end = b
            if busy > 0:
                done[i] = (busy / 1e3, dev, events, rng, st)
        todo = [i for i in todo if i not in done]
        if not todo:
            break
        log(f"[profiler] device_busy session {attempt + 1} recorded no "
            f"device activity for {[calls[i][0] for i in todo]}")
    if todo:
        raise AssertionError(f"{calls[todo[0]][0]}: torch.profiler recorded "
                             "no device activity")
    out = []
    for i, (label, _, _, unprofiled_ms) in enumerate(calls):
        busy, dev, events, rng, st = done[i]
        wall = st["wall"]
        by_name = {}
        for e in dev:
            t = by_name.setdefault(e.name, [0.0, 0])
            t[0] += (e.time_range.end - e.time_range.start) / 1e3
            t[1] += 1
        per_kernel = {}
        for k, kn in KERNEL_NAMES.items():
            us = kernel_records(events, kn, rng)
            if st["launched"][k]:
                per_kernel[k] = {"launches": st["launched"][k],
                                 "recorded": len(us),
                                 "device_ms": sum(us) / 1e3}
        log(f"[busy {label}] device busy {busy:.3f} ms; profiled wall "
            f"{wall:.3f} ms (share {busy / wall:.3f}); unprofiled median "
            f"{unprofiled_ms:.3f} ms (share {busy / unprofiled_ms:.3f})")
        for k, (ms, count) in sorted(by_name.items(),
                                     key=lambda kv: -kv[1][0])[:8]:
            log(f"  {k[:60]:<60} {ms:8.3f} ms x{count}")
        log("  per call, launches x device ms: " + ", ".join(
            f"{k} {v['launches']} x "
            f"{v['device_ms'] / max(v['recorded'], 1):.4f} "
            f"({v['recorded']} recorded, {v['device_ms']:.4f} ms)"
            for k, v in per_kernel.items()))
        out.append({"label": label, "busy_ms": busy, "profiled_wall_ms": wall,
                    "share_profiled": busy / wall,
                    "share_unprofiled": busy / unprofiled_ms,
                    "per_kernel": per_kernel})
    return out


# ---------------------------------------------------------------------------
# The NTT slice
# ---------------------------------------------------------------------------

def horner(coeffs: list, points: list, p: int) -> list:
    """sum_j c_j x^j mod p at each point, one pass over the coefficients."""
    accs = [0] * len(points)
    for c in reversed(coeffs):
        accs = [(a * x + c) % p for a, x in zip(accs, points)]
    return accs


def ntt_case(fr, log_n: int, seed: int) -> dict:
    """Canonical random elements (top word below r's, so every value is
    below r and the INTT roundtrip returns the same bytes) as wire bytes,
    and their words as Python ints for the spot checks."""
    n = 1 << log_n
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8),
                                             dtype=np.uint64)
    w[:, 7] %= fr.modulus >> 224
    data = w.astype("<u4").tobytes()
    ints = [int.from_bytes(data[i:i + 32], "little")
            for i in range(0, len(data), 32)]
    return {"log_n": log_n, "n": n, "data": data, "ints": ints}


def spot_check(fr, case: dict, out: bytes, omega: int, ks: list, what: str):
    """out[k] == sum_j c_j omega^(j k) mod r for the wire words c_j: the
    Montgomery factors of input and output cancel."""
    p = fr.modulus
    got = [int.from_bytes(out[32 * k:32 * k + 32], "little") for k in ks]
    want = horner(case["ints"], [pow(omega, k, p) for k in ks], p)
    if got != want:
        raise AssertionError(f"{what} 2^{case['log_n']}: spot check failed "
                             f"at k in {ks}")


def ntt_timed(label: str, call, want: bytes, reps: int, n: int,
              card: str) -> dict:
    """Host wall time of ``reps`` steady calls (each ends with its bytes on
    the host, which must equal ``want``), median / min / max, and
    elements/s at the median."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = call()
        times.append((time.perf_counter() - t0) * 1e3)
        if blob != want:
            raise AssertionError(f"{label}: repeat call bytes differ")
    s = spread(times)
    log(f"[ntt {label}] ms/call over {reps} calls: median "
        f"{s['median_ms']:.3f}, min {s['min_ms']:.3f}, max {s['max_ms']:.3f};"
        f" {n / s['median_ms'] * 1e3:.0f} elements/s at the median on {card}")
    return {**s, "elements_per_s": n / s["median_ms"] * 1e3, "calls_ms": times}


ENGINES = {"auto": "four-step", "pallas": "radix-2"}
ENGINE_NAMES = {**ENGINES, "mxu": "four-step", "jnp": "stagewise"}


@contextlib.contextmanager
def ntt_engine(impl: str):
    """Sets PANDA_NTT_IMPL, which run_ntt reads at call time, and restores
    it after."""
    old = os.environ.get("PANDA_NTT_IMPL")
    os.environ["PANDA_NTT_IMPL"] = impl
    try:
        yield
    finally:
        if old is None:
            del os.environ["PANDA_NTT_IMPL"]
        else:
            os.environ["PANDA_NTT_IMPL"] = old


def forward_alias(curve):
    from panda_tpu_torch.runtime import api
    return {"bn254": api.ntt_bn254, "bls12_377": api.ntt_bls12_377,
            "bls12_381": api.ntt_bls12_381}[curve.name]


_GATE_CASES: dict = {}


def gate_case(curve) -> tuple:
    """The 2^12 gate's input bytes (random words below 2^256, some >= r)
    and ntt_ref's forward and inverse bytes, computed once a curve (the
    O(n^2) oracle takes seconds)."""
    from panda_tpu_torch.reference import ntt_ref
    if curve.name not in _GATE_CASES:
        fr = curve.fr
        log_n, p = 12, fr.modulus
        g = random.Random(12)
        words = [g.randrange(1 << 256) for _ in range(1 << log_n)]
        words[:3] = [p, p + 5, (1 << 256) - 1]
        data = b"".join(v.to_bytes(32, "little") for v in words)
        vals = [fr.from_wire_int(v) for v in words]
        w = fr.root_of_unity(log_n)
        wire = lambda vs: b"".join(fr.to_wire_int(v).to_bytes(32, "little")
                                   for v in vs)            # noqa: E731
        _GATE_CASES[curve.name] = (data, (
            wire(ntt_ref.ntt_oracle(fr, vals, w)),
            wire(ntt_ref.intt_oracle(fr, vals, w))))
    return _GATE_CASES[curve.name]


def ntt_small_gate(curve, device, impls) -> None:
    """2^12, with each engine of ``impls``: forward and inverse bytes equal
    the big-int NTT oracle's, for inputs that include words >= r (any value
    below 2^256 is taken)."""
    from panda_tpu_torch import InitUnitType, PandaManager
    from panda_tpu_torch.runtime import api
    log_n = 12
    data, want = gate_case(curve)
    for impl in impls:
        with ntt_engine(impl):
            gm = PandaManager.init_all(0, InitUnitType.NTT, curve=curve,
                                       device=device)
            got = (forward_alias(curve)(gm, data, log_n),
                   api.intt(gm, data, log_n))
        if got != want:
            raise AssertionError(f"{curve.name} NTT 2^12 "
                                 f"({ENGINE_NAMES[impl]}) != ntt_ref")
    log(f"[ntt {curve.name} 2^12] forward and inverse bytes equal ntt_ref "
        f"({', '.join(ENGINE_NAMES[i] for i in impls)})")


def ntt_slice(curve, case: dict, card: str, reps: int, device,
              impl: str = "auto", ref: dict | None = None) -> dict:
    """Phase 4 for the NTT at one size with one engine: forward, inverse
    and v1 with the root w^3, held to the spot checks (or, given ``ref``,
    another engine's result for this case, to its bytes) and the
    roundtrip; then the timed calls and the device time of run_ntt alone.
    Leaves {gm, out, out3} in case[impl]."""
    import torch
    from panda_tpu_torch import InitUnitType, PandaManager
    from panda_tpu_torch.fields import mont
    from panda_tpu_torch.ops import ntt as ntt_ops
    from panda_tpu_torch.runtime import api
    fr = curve.fr
    log_n, n, data = case["log_n"], case["n"], case["data"]
    p = fr.modulus
    tag = f"[ntt {curve.name} {ENGINE_NAMES[impl]} 2^{log_n}]"
    fwd = forward_alias(curve)
    w3 = pow(fr.root_of_unity(log_n), 3, p)
    g = random.Random(log_n)
    ks = [0, 1, n - 1, g.randrange(n)]
    with ntt_engine(impl):
        gm = PandaManager.init_all(0, InitUnitType.NTT, curve=curve,
                                   device=device)
        t0 = time.perf_counter()
        out = fwd(gm, data, log_n)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = api.intt(gm, out, log_n)
        first_inv = time.perf_counter() - t0
        if back != data:
            raise AssertionError(f"{tag} INTT(NTT): roundtrip bytes differ")
        out3 = api.ntt_v1(gm, data, log_n,
                          fr.to_wire_int(w3).to_bytes(32, "little"))
        if ref is None:
            spot_check(fr, case, out, fr.root_of_unity(log_n), ks, "NTT")
            spot_check(fr, case, out3, w3, ks, "NTT v1 (root w^3)")
            held = f"spot checks at k = {ks} exact (forward and v1)"
        else:
            if (out, out3) != (ref["out"], ref["out3"]):
                raise AssertionError(f"{tag} bytes differ from the other "
                                     "engine's")
            held = "forward and v1 bytes equal the four-step engine's"
        log(f"{tag} roundtrip exact, {held}; first call {first:.3f} s, first "
            f"inverse {first_inv:.3f} s (tables built)")
        name = ENGINE_NAMES[impl]
        res = {"curve": curve.name, "engine": name, "log_n": log_n,
               "first_s": first, "first_inverse_s": first_inv,
               "forward": ntt_timed(f"{curve.name} {name} forward 2^{log_n}",
                                    lambda: fwd(gm, data, log_n), out, reps,
                                    n, card),
               "inverse": ntt_timed(f"{curve.name} {name} inverse 2^{log_n}",
                                    lambda: api.intt(gm, out, log_n), data,
                                    reps, n, card)}
        x = mont.bytes_to_tensor(fr, data, device)
        tables = gm.ntt_tables(log_n)
        mem0 = torch.cuda.memory_stats(device)
        dev = cuda_ms(lambda: ntt_ops.run_ntt(fr, x, tables), reps)
        mem1 = torch.cuda.memory_stats(device)
    res["device_ms"] = dev
    res["device_elements_per_s"] = n / dev * 1e3
    # the caching allocator's own device allocations and retries (which
    # free its cache and synchronise) during the timed calls
    alloc = {k: mem1[k] - mem0[k]
             for k in ("num_device_alloc", "num_alloc_retries") if k in mem1}
    res["allocator"] = {**alloc, "reserved_gib":
                        mem1.get("reserved_bytes.all.current", 0) / 2**30}
    log(f"{tag} run_ntt alone on the device (CUDA events, {reps} calls): "
        f"{dev:.3f} ms, {n / dev * 1e3:.0f} elements/s; allocator during "
        f"them: {res['allocator']}")
    case[impl] = {"gm": gm, "out": out, "out3": out3}
    return res


def radix2_launches(case: dict) -> dict:
    """One steady radix-2 forward call's launches (the counters' change):
    small_ntt must launch and the DFT must not."""
    from panda_tpu_torch.ops import _ext
    from panda_tpu_torch.runtime import api
    before = dict(_ext.launches)
    with ntt_engine("pallas"):
        out = api.ntt_bn254(case["pallas"]["gm"], case["data"], case["log_n"])
    delta = {k: _ext.launches[k] - before[k] for k in before}
    if out != case["auto"]["out"]:
        raise AssertionError("radix-2 steady call: bytes differ")
    if delta["small_ntt"] == 0 or delta["dft"]:
        raise AssertionError(f"radix-2 2^{case['log_n']} call launched "
                             f"{delta}")
    log(f"[ntt radix-2 2^{case['log_n']}] one steady call launches {delta}")
    return delta


def engines_2_8(fr, device) -> dict:
    """run_ntt at 2^8 on any words below 2^256 with the four-step plan
    (impl mxu): its output and its device ms a call (CUDA events, 20
    calls), before the stagewise path is counted; that path then holds
    auto, the stagewise engine below 2^10, to these bytes."""
    from panda_tpu_torch.ops import ntt as ntt_ops
    x = random_words(1 << 8, 8).to(device)
    tables = ntt_ops.make_tables(fr, 8)
    run = lambda: ntt_ops.run_ntt(fr, x, tables, impl="mxu")  # noqa: E731
    return {"x": x, "tables": tables, "mxu": run(),
            "mxu_ms": cuda_ms(run, 20)}


def stagewise_path(curve, device, card, small: dict,
                   case: dict | None = None) -> dict:
    """Phase 4 for the stagewise engine (PANDA_NTT_IMPL=jnp) over one
    field: the byte API at 2^12 against ntt_ref; run_ntt at 2^8 with auto
    (the stagewise engine there) byte-equal to ``small``'s four-step
    output, with the device ms a call of both; and, given ``case`` (BN254
    at 2^20), the roundtrip, spot checks and 3 timed calls of
    ntt_slice."""
    import torch
    from panda_tpu_torch.ops import ntt as ntt_ops
    fr = curve.fr
    ntt_small_gate(curve, device, ("jnp",))
    x, tables = small["x"], small["tables"]
    run = lambda: ntt_ops.run_ntt(fr, x, tables, impl="auto")  # noqa: E731
    if not torch.equal(run(), small["mxu"]):
        raise AssertionError(f"{curve.name} NTT 2^8: auto (stagewise) bytes "
                             "differ from the four-step plan's")
    res = {"curve": curve.name, "auto_2_8_ms": cuda_ms(run, 20),
           "mxu_2_8_ms": small["mxu_ms"]}
    log(f"[ntt {curve.name} 2^8] auto (stagewise) bytes equal the four-step "
        f"plan's; run_ntt {res['auto_2_8_ms']:.4f} ms a call against "
        f"{res['mxu_2_8_ms']:.4f} (four-step), CUDA events, 20 calls, on "
        f"{card}")
    if case is not None:
        res["2^20"] = ntt_slice(curve, case, card, 3, device, "jnp")
    return res


def ntt_stage_breakdown(fr, case: dict, reps: int, impl: str = "auto") -> dict:
    """Phase 5 for the NTT: the byte-API forward call of one engine run
    stage by stage with a device synchronise around each stage (host
    clock), the calls api._ntt_run and the engine's _transform make, in
    their order; the bytes are held to the API's.  Per-stage {median_ms,
    min_ms, max_ms} over ``reps`` calls."""
    import torch
    from panda_tpu_torch.ops import _ext, fmul, ntt_fused, ntt_mxu, ntt_pallas
    st = case[impl]
    gm, log_n, data = st["gm"], case["log_n"], case["data"]
    engine = "pallas" if impl == "pallas" else "mxu"
    plan = gm.ntt_tables(log_n).plan(False, gm.device, engine)
    rows = {}
    for _ in range(reps):
        _ext.reset_counts()
        cur = {}

        def timed(stage, fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            cur[stage] = cur.get(stage, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        def four_step(level, x, canonical):
            top = " + canonical pass" if canonical else ""
            lvl_tabs, leaf_mat = ntt_mxu.plan_tables(plan)
            if level == len(plan.levels):
                lk = plan.leaf[0]
                return timed(f"dft leaf (K = 2^{lk}){top}",
                             ntt_fused.dft_apply_fused, fr, x, lk, leaf_mat,
                             canonical)
            la, lb, _, _ = plan.levels[level]
            t1t, mat = lvl_tabs[level]
            A, B = 1 << la, 1 << lb
            W, M, batch = x.shape
            y = four_step(level + 1, x.reshape(W, B, A * batch), False)
            z = timed("transposes", lambda: y.reshape(W, B, A, batch)
                      .permute(0, 2, 1, 3).contiguous())
            pre = timed("twiddle table broadcast", lambda: t1t.unsqueeze(-1)
                        .expand(W, A, B, batch).reshape(W, -1).contiguous())
            z = timed("fmul (twiddles)", fmul.fmul, fr, z.reshape(W, -1), pre)
            return timed(f"dft level {level} (K = 2^{la}){top}",
                         ntt_fused.dft_apply_fused, fr,
                         z.reshape(W, A, B * batch), la, mat,
                         canonical).reshape(W, A * B, batch)

        def radix2(level, x, canonical):
            top = " + canonical store" if canonical else ""
            if level == len(plan.levels):
                lk, tw = plan.leaf
                return timed(f"small_ntt leaf (K = 2^{lk}, reduce at load)"
                             f"{top}", ntt_pallas.small_ntt_batch, fr, x, lk,
                             tw, None, None, True, canonical)
            la, lb, t1t, tw = plan.levels[level]
            A, B = 1 << la, 1 << lb
            W, M, batch = x.shape
            # the pass reads the inner level's output where it lies (no
            # transpose stage)
            y = radix2(level + 1, x.reshape(W, B, A * batch), False)
            return timed(f"small_ntt level {level} (K = 2^{la}, T1 at load, "
                         f"runs of {batch}){top}", ntt_pallas.small_ntt_batch,
                         fr, y.reshape(W, B, A, batch), la, tw, t1t, None,
                         False, canonical).reshape(W, A * B, batch)

        tr = radix2 if engine == "pallas" else four_step
        raw = timed("ingest: bytes to rows (host)", lambda: torch.from_numpy(
            np.frombuffer(data, np.uint8).view("<i4").reshape(-1, 8).copy()))
        xd = timed("ingest: copy to device", lambda: raw.to(gm.device))
        x = timed("ingest: transpose on device", lambda: xd.t().contiguous())
        y = tr(0, x.reshape(8, -1, 1), True).reshape(8, -1)
        yt = timed("output: transpose on device", lambda: y.t().contiguous())
        host = timed("output: copy to host", lambda: yt.cpu())
        blob = timed("output: bytes (host)", lambda: host.numpy().tobytes())
        if blob != st["out"]:
            raise AssertionError(f"NTT stage breakdown 2^{log_n}: bytes "
                                 "differ from the API's")
        for k, v in cur.items():
            rows.setdefault(k, []).append(v)
    out = {k: spread(v) for k, v in rows.items()}
    out["total"] = spread([sum(rows[k][i] for k in rows) for i in range(reps)])
    log(f"[ntt stages {ENGINES[impl]} 2^{log_n}] levels "
        f"{[l[:2] for l in plan.levels]}, leaf 2^{plan.leaf[0]}; ms per call "
        f"over {reps} calls, synchronised stages (median / min / max):")
    for k, v in out.items():
        log(f"  {k:<60} {v['median_ms']:9.3f} {v['min_ms']:9.3f} "
            f"{v['max_ms']:9.3f}")
    log(f"  launches in one call: {dict(_ext.launches)}")
    return {"log_n": log_n, "engine": ENGINES[impl], "stages": out,
            "launches": dict(_ext.launches)}


# The TPU kernel each kernel library replaces; buckets.cu replaces the
# MSM path's use of point_pallas.py's _run (its tail scan and final add).
REPLACES = {"digits": "panda_tpu/ops/digits_pallas.py:77",
            "hist": "panda_tpu/ops/hist_pallas.py:63",
            "phase_a": "panda_tpu/ops/phase_a_pallas.py:257",
            "buckets": "panda_tpu/ops/point_pallas.py:48",
            "point_ops": "panda_tpu/ops/point_pallas.py:48",
            "wscan": "panda_tpu/ops/point_pallas.py:167",
            "fmul": "panda_tpu/ops/point_pallas.py:251",
            "dft": "panda_tpu/ops/ntt_fused.py:83",
            "small_ntt": "panda_tpu/ops/ntt_pallas.py:130",
            "dg3": "tools/profile_gather4.py:78"}
MSM_KERNELS = ("digits", "hist", "phase_a", "buckets", "wscan")
POINT_API_KERNELS = ("point_ops",)
NTT_KERNELS = ("fmul", "dft")
RADIX2_KERNELS = ("small_ntt",)
BLS_KERNELS = ("fmul", "dft", "small_ntt")
STAGEWISE_KERNELS = ("fmul",)
PROBE_KERNELS = ("dg3",)


# Registers a thread of each BN254 kernel entry (ptxas -v, sm_90a; no
# stack, no spills): digits as before the MSM kernels were templated on the
# curve; the point ops as redesigned for the H100 (mont_mul_wide products;
# padd and pdbl at launch bounds 128 x 4, pmadd with none); phase A and
# wscan as redesigned for the H100
# (phase A's cp.async ring at launch bounds 128 x 4; the two-level
# weighted reduction at 128 x 2, without the overlapped scaling that the
# 12-word curves keep, where it was 128 registers a thread as one column a
# thread); hist with its bins in shared memory (16 with a global atomic a
# digit); the bucket assembly's tails launch at 128 x 2 and its fill.
BN254_REGISTERS = {"digits_kernel": 32, "hist_kernel": 29,
                   "phase_a_kernel": 128, "buckets_tails_kernel": 202,
                   "buckets_fill_kernel": 40, "padd_kernel": 128,
                   "pmadd_kernel": 128, "pdbl_kernel": 128,
                   "wscan_kernel": 253}
# The same for the NTT kernels' BN254 Fr and BLS12-377 Fr instantiations:
# fmul and the DFT from before they took BLS12-381 Fr; small_ntt as
# redesigned for the H100, each field's instantiation for the build's r = 8
# elements a thread at launch bounds 256 x 2 (the BN254 Fr one spills 12
# bytes, the BLS12-377 Fr one 4) and for r = 2 (K of 2 and 4).
NTT_REGISTERS = {"fmul_kernel": {"Fr254": 31, "Fr377": 32},
                 "dft_kernel": {"Fr254": 124, "Fr377": 124},
                 "small_ntt_kernel": {"Fr254, 8": 128, "Fr377, 8": 128,
                                      "Fr254, 2": 64, "Fr377, 2": 64}}
# The struct a template instantiation names in its mangled entry, by curve.
INSTANCE = {"bn254": ("Bn254", "Fr254"), "bls12_377": ("Bls12_377", "Fr377"),
            "bls12_381": ("Bls12_381", "Fr381")}


def entry_name(entry: str) -> str:
    """A ptxas entry's kernel name and, for a template, its curve or field
    struct (mangled names hold both) and, for small_ntt, its elements a
    thread (the mangled int argument)."""
    short = next((kn for kns in KERNEL_NAMES.values() for kn in kns
                  if kn in entry), entry[:40])
    tags = [t for ts in INSTANCE.values() for t in ts if t in entry]
    r = re.search(r"ELi(\d+)E", entry) if short == "small_ntt_kernel" \
        else None
    if r:
        tags = [f"{tags[0]}, {r.group(1)}"]
    return f"{short}<{tags[0]}>" if tags else short


def instance_usage(usage: dict, lib: str, curve: str) -> list:
    """(entry, registers, stack, spill stores, spill loads) of kernel library
    ``lib``'s instantiations for ``curve``."""
    return [(entry_name(e), *rest) for e, *rest in usage[lib]
            if any(t in e for t in INSTANCE[curve])]


def bn254_register_check(usage: dict) -> list:
    """Each BN254 instantiation of the MSM kernels against BN254_REGISTERS;
    returns the entries that differ or spill (logged, not a gate)."""
    differ = []
    for lib in ("digits", "hist", "phase_a", "buckets", "point_ops",
                "wscan"):
        rows = usage[lib] if lib == "hist" else \
            [(e, *r) for e, *r in usage[lib]
             if any(t in e for t in INSTANCE["bn254"])]
        for e, regs, stack, st, ld in rows:
            name = entry_name(e).split("<")[0]
            if regs != BN254_REGISTERS[name] or stack or st or ld:
                differ.append((entry_name(e), regs, stack, st, ld))
    for lib in ("fmul", "dft", "small_ntt"):
        for e, regs, stack, st, ld in usage[lib]:
            name, _, tag = entry_name(e).rstrip(">").partition("<")
            want = NTT_REGISTERS[name].get(tag)
            if want is not None and (regs != want or stack or st or ld):
                differ.append((entry_name(e), regs, stack, st, ld))
    log("[build] BN254 instantiations against their registers "
        f"{BN254_REGISTERS}, and the BN254 Fr and BLS12-377 "
        f"Fr NTT instantiations against theirs (fmul and the DFT from "
        f"before BLS12-381 Fr, small_ntt as redesigned) {NTT_REGISTERS}: "
        + ("all equal, no stack, no spills" if not differ
           else f"differ: {differ}"))
    return differ


def call_bound(launch_bounds: list, launches: int) -> float:
    """The least time of ``launches`` launches that repeat a call whose
    launches have the bounds ``launch_bounds`` (a launch each, in order):
    each launch's bound at its own shape, summed over the call."""
    calls, rest = divmod(launches, len(launch_bounds))
    if rest:
        raise AssertionError(f"{launches} launches are not calls of "
                             f"{len(launch_bounds)}")
    return calls * sum(launch_bounds)


def gap_ranking(busy: list, call_bounds: dict) -> list:
    """Per call at 2^20 (the profiled MSM call of each curve and each
    engine's BN254 NTT call; ``call_bounds`` maps its label to each
    kernel's per-launch bounds, each at its launch's own shape, in the
    order of one call of the kernel's function): each kernel's device ms
    minus the sum of its launches' bounds, largest first: where kernel work
    gains the most.  Every kernel that launched in the call is ranked; one
    whose launches differ in shape ranks only from a complete profiler
    record."""
    rows = []
    for b in busy:
        bounds = call_bounds.get(b["label"])
        if bounds is None:
            continue
        for k, v in b["per_kernel"].items():
            if not v["recorded"]:
                continue
            lb = bounds[k]
            device = v["device_ms"]
            if v["recorded"] < v["launches"]:
                if len(set(lb)) > 1:
                    log(f"[ranking] {k} ({b['label']}): {v['recorded']} of "
                        f"{v['launches']} launches recorded, not ranked")
                    continue
                device *= v["launches"] / v["recorded"]
            bnd = call_bound(lb, v["launches"])
            rows.append({"call": b["label"], "kernel": k,
                         "launches": v["launches"], "device_ms": device,
                         "launch_bounds_ms": lb, "bound_ms": bnd,
                         "gap_ms": device - bnd})
    rows.sort(key=lambda r: -r["gap_ms"])
    log("[ranking] per call at 2^20, device ms of a kernel's launches minus "
        "the sum of their bounds, each at its own shape; dg3 is on no path "
        "of the system and is not ranked: " +
        "; ".join(f"{r['kernel']} ({r['call']}) {r['launches']} launches, "
                  f"{r['device_ms']:.4f} ms, bounds a launch "
                  f"{[round(x, 4) for x in r['launch_bounds_ms']]}, gap "
                  f"{r['gap_ms']:.3f} ms" for r in rows))
    return rows


def top_of_range(busy: list, res20: dict) -> dict:
    """digits and padd in the profiled BN254 2^24 call (phase 6): device ms
    a launch (the call's records over its launches) beside the bound of a
    launch, digits' at 2^24 scalars (their words read, W digits of 5 bytes
    written, one product a scalar) and padd's at its (8, 16, 32768) tables
    (res20's, the same shape)."""
    from panda_tpu_torch.ops import msm
    from panda_tpu_torch.curves.config import BN254
    n = 1 << 24
    W = msm.signed_window_count(BN254.fr.bits, msm.window_bits(
        24, bits=BN254.fr.bits))
    pk = next(b for b in busy if b["label"] == "MSM 2^24")["per_kernel"]
    bounds = {"digits": bound(n * 32 + W * n * 5, n * MONT_MUL_IMADS,
                              IMAD_PER_S),
              "point_ops": {k: res20["point_ops"][k]
                            for k in ("bound_ms", "bound_by")}}
    out = {}
    for k, b in bounds.items():
        v = pk[k]
        ms = v["device_ms"] / v["recorded"] if v["recorded"] else None
        out[k] = {"launches": v["launches"], "recorded": v["recorded"],
                  "ms": ms, **b,
                  "share_of_bound": b["bound_ms"] / ms if ms else None}
    log("[2^24] BN254 profiled call, device ms a launch (bound, share): " +
        "; ".join(f"{k} {v['launches']} x {v['ms']} ({v['bound_ms']:.4f} "
                  f"{v['bound_by']}, {v['share_of_bound']})"
                  for k, v in out.items()))
    return out


def counted(kernels, run, absent=()):
    """Run one main path with every launch counter set to 0 just before it;
    fail unless each of ``kernels`` launched and none of ``absent`` did.
    Returns (run's result, counts of every kernel)."""
    from panda_tpu_torch.ops import _ext
    _ext.reset_counts()
    out = run()
    counts = dict(_ext.launches)
    log(f"[slice] kernel launches: {counts}")
    dead = [k for k in kernels if counts[k] == 0]
    if dead:
        raise AssertionError(f"kernels never launched on the main path: {dead}")
    stray = [k for k in absent if counts[k]]
    if stray:
        raise AssertionError(f"kernels launched off the main path: {stray}")
    return out, counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from panda_tpu_torch.curves.config import BLS12_377, BLS12_381, BN254
    from panda_tpu_torch.ops import _ext
    fr = BN254.fr
    bls_curves = (BLS12_377, BLS12_381)

    # 1. environment
    card = nvidia_smi_line()
    nv = subprocess.run([_ext.nvcc(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        tri = triton.__version__
    except ImportError:
        tri = "not importable"
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; nvcc: {nv}; "
        f"triton {tri}; host cpus {os.cpu_count()} ({host_cpu_model()}), "
        f"load average {os.getloadavg()}")
    log(card)
    device = torch.device("cuda", 0)
    phase_s, last = {}, [time.perf_counter()]

    def mark(name):
        """Log the seconds since the last mark as ``name``'s."""
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        log(f"[time] {name}: {phase_s[name]:.1f} s")
        last[0] = now

    # 2. build
    log(f"[build] {len(_ext.KERNELS)} kernels in {_ext.build_all():.1f} s")
    usage = ptxas_usage()
    log("[build] ptxas -v, registers / stack / spill stores / spill loads "
        "(bytes) a thread: " + "; ".join(
            f"{name} {entry_name(entry)} {regs} / {stack} / {st} / {ld}"
            for name, rows in usage.items()
            for entry, regs, stack, st, ld in rows))
    bn254_registers = bn254_register_check(usage)
    mark("build and ptxas")

    # 3. kernels against their plain versions (the MSM kernels of BN254 and
    #    both BLS curves, the NTT kernels of the three scalar fields, all
    #    timed); every curve and field has a kernel id
    timer = DeviceTimes()
    res = kernel_checks(BN254, 1 << 16, device, timer)
    res20 = kernel_checks(BN254, 1 << 20, device, timer, plain_times=False)
    timer.take()               # one profiler session a group (DeviceTimes)
    bls_res = {}
    for cv in bls_curves:
        bls_res[cv.name] = kernel_checks(cv, 1 << 16, device, timer)
        bls_res[f"{cv.name} 2^20"] = kernel_checks(
            cv, 1 << 20, device, timer, plain_times=False)
    timer.take()
    res.update(ntt_kernel_checks(fr, 20, device, timer))
    ntt_res = {cv.name: ntt_kernel_checks(cv.fr, 20, device, timer)
               for cv in bls_curves}
    ids = kernel_ids()
    dg3_by_r = gather_checks(device, timer)
    res["dg3"] = dict(dg3_by_r[8], max_abs_err=max(
        r["max_abs_err"] for r in dg3_by_r.values()))
    log("[kernels] device ms a launch (torch.profiler), batch ms a call, "
        "bound ms: " + "; ".join(
            f"{k}{tag} {v['ms']:.4f} ({v['recorded']}), {v['batch_ms']:.4f}, "
            f"{v['bound_ms']:.4f}"
            for tag, r in (("", res), (" 2^20", res20),
                           *((f" {t}", r) for t, r in bls_res.items()),
                           *((f" {t} Fr", r) for t, r in ntt_res.items()))
            for k, v in r.items() if "ms" in v))

    mark("kernel checks")

    # 4. the main paths, each counted on its own; a kernel's launches in
    #    the kernels line are its sum over the paths
    sizes = [slice_inputs(BN254, k, device) for k in (16, 20)]
    runs, counts = counted(MSM_KERNELS,
                           lambda: [slice_run(sl, card, 20) for sl in sizes],
                           absent=POINT_API_KERNELS)
    bn254_counts = dict(counts)

    mark("BN254 MSM path")

    # the point API on the card, counted on its own: point_ops is on no MSM
    # path since the bucket assembly became buckets.cu
    sums, c_16 = window_sums(sizes[0])
    point_api, point_counts = counted(
        POINT_API_KERNELS, lambda: point_api_path(sizes[0], sums, c_16))
    bn254_counts["point_ops"] = point_counts["point_ops"]

    # the BLS MSMs: through the curve's alias (bases bytes in every call)
    # and msm_with_cached_bases, at 2^16 (5 timed calls, to keep the run's
    # time) and 2^20 (10 through the alias, 20 cached), each curve counted
    # on its own
    bls_sizes, bls_runs_msm, bls_counts_msm = {}, {}, {}
    for cv in bls_curves:
        ingest_check(cv, device)
        bls_sizes[cv.name] = [slice_inputs(cv, k, device) for k in (16, 20)]
        bls_runs_msm[cv.name], bls_counts_msm[cv.name] = counted(
            MSM_KERNELS, lambda cv=cv: [
                slice_run(sl, card, 5 if sl["log_n"] == 16 else
                          10 if entry == "alias" else 20, entry)
                for sl in bls_sizes[cv.name]
                for entry in ("alias", "cached")],
            absent=POINT_API_KERNELS)
    mark("BLS MSM paths")

    # the array-level msm.msm (Horner on the card) and the point helpers,
    # each curve counted on its own
    arr_runs, arr_counts = counted(
        MSM_KERNELS + POINT_API_KERNELS,
        lambda: [array_msm_path(sl, card) for sl in sizes])
    arr_381, arr_381_counts = counted(
        MSM_KERNELS + POINT_API_KERNELS,
        lambda: array_msm_path(bls_sizes["bls12_381"][1], card))
    helpers, helper_counts = counted(
        POINT_API_KERNELS, lambda: point_helpers_path(BN254, device, card))
    mark("array msm and point helpers")

    # the MSM above 2^20: 2^22 and 2^24 through msm_with_cached_bases for
    # the three curves, each counted on its own with its exact launches;
    # BN254's sessions stay for the chunks-against-groups measurement and
    # (2^24) phases 5 and 6
    big_runs, big_counts, big_bn = [], {}, {}
    for cv in (BN254, *bls_curves):
        cnt = big_counts.setdefault(cv.name, dict.fromkeys(_ext.KERNELS, 0))
        for log_n in (22, 24):
            sl = slice_inputs(cv, log_n, device)
            run = big_msm_path(sl, card, 3 if log_n == 22 else 2)
            big_runs.append(run)
            for k, v in run["launches"].items():
                cnt[k] += v
            if cv is BN254:
                big_bn[log_n] = sl
            else:
                sl["gm"].deinit()
    chunk_groups = [chunk_vs_groups(big_bn[k], card, 3) for k in (22, 24)]
    big_bn[22]["gm"].deinit()
    mark("MSM above 2^20")
    host_runs = msm_host_path(device, card)
    zero_root, zero_counts = counted(
        STAGEWISE_KERNELS, lambda: zero_root_path(device),
        absent=("dft", "small_ntt"))
    mark("msm_host and the zero-root NTT")

    cases = [ntt_case(fr, k, 20261016 + k) for k in (20, 22)]
    bls_case = ntt_case(BLS12_377.fr, 20, 377)
    bls381_case = ntt_case(BLS12_381.fr, 20, 381)
    sw_case = ntt_case(fr, 20, 20261017)

    def four_step():
        ntt_small_gate(BN254, device, ("auto",))
        return [ntt_slice(BN254, cs, card, r, device)
                for cs, r in zip(cases, (20, 10))]

    def radix2():
        ntt_small_gate(BN254, device, ("pallas",))
        out = [ntt_slice(BN254, cs, card, r, device, "pallas", cs["auto"])
               for cs, r in zip(cases, (20, 10))]
        radix2_launches(cases[0])
        return out

    def bls12_377():
        ntt_small_gate(BLS12_377, device, tuple(ENGINES))
        auto = ntt_slice(BLS12_377, bls_case, card, 10, device)
        return [auto, ntt_slice(BLS12_377, bls_case, card, 10, device,
                                "pallas", bls_case["auto"])]

    def bls12_381_four_step():
        ntt_small_gate(BLS12_381, device, ("auto",))
        return ntt_slice(BLS12_381, bls381_case, card, 10, device)

    def bls12_381_radix2():
        ntt_small_gate(BLS12_381, device, ("pallas",))
        return ntt_slice(BLS12_381, bls381_case, card, 10, device, "pallas",
                         bls381_case["auto"])

    ntt_runs, ntt_counts = counted(NTT_KERNELS, four_step)
    r2_runs, r2_counts = counted(RADIX2_KERNELS, radix2)
    bls_runs, bls_counts = counted(BLS_KERNELS, bls12_377)
    b381_runs, b381_counts = zip(
        counted(NTT_KERNELS, bls12_381_four_step),
        counted(RADIX2_KERNELS, bls12_381_radix2, absent=("dft",)))
    mark("four-step, radix-2, BLS12-377 and BLS12-381 NTT paths")
    # the stagewise engine, each field counted on its own; the four-step
    # 2^8 references are computed before the counts
    all_curves = (BN254, *bls_curves)
    small = {cv.name: engines_2_8(cv.fr, device) for cv in all_curves}
    sw_runs, sw_counts = {}, {}
    for cv in all_curves:
        sw_runs[cv.name], sw_counts[cv.name] = counted(
            STAGEWISE_KERNELS, lambda cv=cv: stagewise_path(
                cv, device, card, small[cv.name],
                sw_case if cv is BN254 else None),
            absent=("dft", "small_ntt"))

    mark("stagewise paths")

    def probe():
        from panda_tpu_torch.tools import profile_gather4
        rows = profile_gather4.main(device)
        if [(r["case"], r["R"]) for r in rows] != \
                [("row gather", R) for R in (9, 12, 16, 8)] + \
                [("dg3", R) for R in profile_gather4.DEPTHS] or \
                not all(0 < r["ms"] < float("inf") for r in rows):
            raise AssertionError(f"gather probe: unexpected cases {rows}")
        for r in rows:
            r.update(bound(r["bytes"], 0, IMAD_PER_S))
        log("[probe] bound ms a call (bytes): " + ", ".join(
            f"{r['case']} R = {r['R']} {r['bound_ms']:.4f}" for r in rows))
        return rows

    probe_rows, probe_counts = counted(PROBE_KERNELS, probe)
    layout = probe_layout_line(sizes[1], probe_rows, res20["phase_a"]["ms"],
                               card)
    for c in (point_counts, ntt_counts, r2_counts, bls_counts, *b381_counts,
              *sw_counts.values(), probe_counts, *bls_counts_msm.values(),
              arr_counts, arr_381_counts, helper_counts,
              *big_counts.values(), zero_counts):
        for k, v in c.items():
            counts[k] += v
    # each curve's MSM-kernel launches on its paths (the by-curve rows)
    for c in (arr_counts, helper_counts, big_counts["bn254"]):
        for k, v in c.items():
            bn254_counts[k] += v
    for cv in bls_curves:
        for c in (big_counts[cv.name],
                  arr_381_counts if cv is BLS12_381 else {}):
            for k, v in c.items():
                bls_counts_msm[cv.name][k] += v

    mark("gather probe")

    # the multi-rank paths and the native caller; rank 0's launches of the
    # four gloo ranks' cases join the kernels line
    sharded = sharded_paths(device, card)
    for row in sharded["gloo_4"]:
        for k, v in row["launches_rank0"].items():
            counts[k] += v
    mark("sharded paths, dry runs and the native caller")

    # 5. where the time goes, 6. device busy share (not counted)
    from panda_tpu_torch.runtime import api
    stages = [stage_breakdown(BN254, sl, 10) for sl in sizes]
    stages.append(stage_breakdown(BLS12_381, bls_sizes["bls12_381"][1], 10))
    stages.append(stage_breakdown(BN254, big_bn[24], 3))
    stages += [ntt_stage_breakdown(fr, cases[0], 10, impl) for impl in ENGINES]
    def ntt_call(cs, impl):
        def call():
            with ntt_engine(impl):
                return api.ntt_bn254(cs[impl]["gm"], cs["data"], cs["log_n"])
        return call

    busy = device_busy(
        [(f"MSM 2^{sl['log_n']}",
          lambda sl=sl: api.msm_bn254_with_cached_bases(sl["gm"],
                                                        sl["scalars"], 0),
          sl["want"], r["median_ms"]) for sl, r in zip(sizes, runs)] +
        [("MSM 2^24", lambda: api.msm_bn254_with_cached_bases(
            big_bn[24]["gm"], big_bn[24]["scalars"], 0), big_bn[24]["want"],
          next(r["median_ms"] for r in big_runs
               if (r["curve"], r["log_n"]) == ("bn254", 24)))] +
        [(f"BLS12-{cv.name[-3:]} MSM 2^20",
          lambda sl=bls_sizes[cv.name][1]: api.msm_with_cached_bases(
              sl["gm"], sl["scalars"], 0),
          bls_sizes[cv.name][1]["want"], bls_runs_msm[cv.name][3]["median_ms"])
         for cv in bls_curves] +
        [(f"NTT 2^{cs['log_n']} {ENGINES[impl]}", ntt_call(cs, impl),
          cs["auto"]["out"], run["forward"]["median_ms"])
         for cs, r4, r2 in zip(cases, ntt_runs, r2_runs)
         for impl, run in (("auto", r4), ("pallas", r2))])
    for sl in (*sizes, *(s for v in bls_sizes.values() for s in v),
               big_bn[24]):
        sl["gm"].deinit()
    for cs in (*cases, bls_case, bls381_case):
        for impl in ENGINES:
            cs[impl]["gm"].deinit()
    sw_case["jnp"]["gm"].deinit()

    # bounds of each launch of a call at the 2^20 shapes: the MSM kernels'
    # from the 2^20 checks (the bucket assembly's two launches and the
    # weighted reduction's two levels each at its own), fmul's and the
    # DFT's from the 2^20 NTT's passes, small_ntt's three passes (the top
    # with its T1 table, then twice K = 64)
    def launch_bounds(r, k):
        return r[k].get("launch_bounds_ms", [r[k]["bound_ms"]])

    bounds = {k: launch_bounds(res20, k) for k in MSM_KERNELS}
    bounds.update({k: launch_bounds(res, k) for k in ("fmul", "dft")})
    bounds["small_ntt"] = [res[k]["bound_ms"] for k in (
        "small_ntt_k64", "small_ntt_k64_t1", "small_ntt")]
    call_bounds = {b["label"]: bounds for b in busy
                   if "2^20" in b["label"] and not b["label"].startswith("BLS")}
    for cv in bls_curves:
        r = bls_res[f"{cv.name} 2^20"]
        call_bounds[f"BLS12-{cv.name[-3:]} MSM 2^20"] = {
            k: launch_bounds(r, k) for k in MSM_KERNELS}
    for b in busy:
        if "MSM 2^20" in b["label"]:
            pk = b["per_kernel"]
            if "point_ops" in pk or pk.get("hist", {}).get("launches") != 1:
                raise AssertionError(f"{b['label']}: launches {pk}, want no "
                                     "point_ops and one hist")
        if b["label"] == "MSM 2^24":
            pk, want = b["per_kernel"], chunked_launches(BN254, 1 << 24, 1)
            if {k: v["launches"] for k, v in pk.items()} != want:
                raise AssertionError(f"MSM 2^24 profiled: launches {pk}, "
                                     f"want {want}")
    mark("stage breakdowns and busy shares")
    ranking = gap_ranking(busy, call_bounds)
    top = top_of_range(busy, res20)

    # the curve-templated MSM kernels: each curve's device ms a launch,
    # launches on its path, bound, plain ms and its instantiations' ptxas
    # rows (phase A also at 2^20)
    for k in ("digits", "phase_a", "buckets", "point_ops", "wscan"):
        by_curve = {}
        for cv, r, n_launch in (
                (BN254, res, bn254_counts),
                *((cv, bls_res[cv.name], bls_counts_msm[cv.name])
                  for cv in bls_curves)):
            by_curve[cv.name] = {
                "ms": r[k]["ms"], "launches": n_launch[k],
                "max_abs_err": r[k]["max_abs_err"],
                "bound_ms": r[k]["bound_ms"], "plain_ms": r[k]["plain_ms"],
                "ptxas": instance_usage(usage, k, cv.name)}
        for cv, r in ((BN254, res20),
                      *((cv, bls_res[f"{cv.name} 2^20"]) for cv in bls_curves)):
            if k in r:
                by_curve[cv.name]["bound_ms_2_20"] = r[k]["bound_ms"]
                if "ms" in r[k]:
                    by_curve[cv.name]["ms_2_20"] = r[k]["ms"]
            if k == "phase_a":
                by_curve[cv.name]["ms_2_20_table_in_l2"] = \
                    r["phase_a_l2"]["ms"]
            if k == "buckets":
                by_curve[cv.name]["ms_2_20_long_runs"] = \
                    r["buckets"]["long_runs"]["ms"]
                by_curve[cv.name]["replaced_point_ops_bound_ms_2_20"] = \
                    r["buckets"]["replaced_point_ops_bound_ms"]
        res[k] = dict(res[k], by_curve=by_curve)
        unit = "call of its launches" if k in ("buckets", "wscan") \
            else "launch"
        log(f"[kernels by curve] {k}: " + "; ".join(
            f"{c} {v['ms']:.4f} ms a {unit} (bound {v['bound_ms']:.4f}, "
            f"plain {v['plain_ms']}), {v['launches']} launches, ptxas "
            f"{[row[1:] for row in v['ptxas']]}"
            + (f", 2^20 {v['ms_2_20']:.4f} ms" if "ms_2_20" in v else "")
            + (f", 2^20 bound {v['bound_ms_2_20']:.4f}"
               if "bound_ms_2_20" in v else "")
            + (f", 2^20 with the table in L2 {v['ms_2_20_table_in_l2']:.4f} ms"
               if "ms_2_20_table_in_l2" in v else "")
            + (f", 2^20 with 8 pool scalars {v['ms_2_20_long_runs']:.4f} ms"
               f" (the point-op launches it replaced: bound "
               f"{v['replaced_point_ops_bound_ms_2_20']:.4f} ms)"
               if "ms_2_20_long_runs" in v else "")
            for c, v in by_curve.items()))

    # the point ops of each curve at both table shapes: device ms a launch
    # against its bound
    point_ops_shapes = {
        f"{cv.name} 2^{log_n}": r["point_ops_variants"]
        for cv, log_n, r in (
            (BN254, 16, res), (BN254, 20, res20),
            *((cv, 16, bls_res[cv.name]) for cv in bls_curves),
            *((cv, 20, bls_res[f"{cv.name} 2^20"]) for cv in bls_curves))}
    log("[point_ops] device ms a launch (bound ms, share of the bound): " +
        "; ".join(f"{key}: " + ", ".join(
            f"{op} {v['ms']:.4f} ({v['bound_ms']:.4f}, "
            f"{v['bound_ms'] / v['ms']:.2f})" for op, v in ops.items())
            for key, ops in point_ops_shapes.items()))

    log("[kernels] hist, device ms a launch (2^16 / 2^20, BN254's digits): "
        f"the main path's digits {res['hist'].get('ms')} / "
        f"{res20['hist'].get('ms')}, one digit a window "
        f"{res['hist']['one_digit'].get('ms')} / "
        f"{res20['hist']['one_digit'].get('ms')}")

    # the NTT kernels: each scalar field's device ms a launch, launches on
    # its paths (four-step, radix-2, stagewise), bound, plain ms and its
    # instantiation's ptxas row
    field_paths = (
        (BN254, res, (ntt_counts, r2_counts, sw_counts["bn254"])),
        (BLS12_377, ntt_res["bls12_377"],
         (bls_counts, sw_counts["bls12_377"])),
        (BLS12_381, ntt_res["bls12_381"],
         (*b381_counts, sw_counts["bls12_381"])))
    for k, extras in (("fmul", ()), ("dft", ("dft_k4",)),
                      ("small_ntt", tuple(f"small_ntt_{key}" for key, *_
                                          in SMALL_NTT_PASSES[1:]))):
        by_field = {}
        for cv, r, path_counts in field_paths:
            row = by_field[cv.fr.name] = {
                "ms": r[k]["ms"], "launches": sum(c[k] for c in path_counts),
                "max_abs_err": r[k]["max_abs_err"],
                "bound_ms": r[k]["bound_ms"], "plain_ms": r[k]["plain_ms"],
                "ptxas": instance_usage(usage, k, cv.name)}
            for extra in extras:
                row.update({f"{extra}_ms": r[extra]["ms"],
                            f"{extra}_bound_ms": r[extra]["bound_ms"],
                            f"{extra}_plain_ms": r[extra]["plain_ms"]})
        res[k] = dict(res[k], by_field=by_field)
        log(f"[kernels by field] {k}: " + "; ".join(
            f"{f} {v['ms']:.4f} ms a launch (bound {v['bound_ms']:.4f}, "
            f"plain {v['plain_ms']:.3f}), {v['launches']} launches, ptxas "
            f"{[row[1:] for row in v['ptxas']]}"
            + "".join(f", {extra} {v[extra + '_ms']:.4f} ms (bound "
                      f"{v[extra + '_bound_ms']:.4f})" for extra in extras)
            for f, v in by_field.items()))

    kernels = [{"name": k, "route": "cuda",
                "source": f"panda_tpu_torch/csrc/{k}.cu",
                "replaces": REPLACES[k], "launches": counts[k], **res[k]}
               for k in _ext.KERNELS]
    log(json.dumps({"slice": runs, "ntt": ntt_runs, "ntt_radix2": r2_runs,
                    "bls12_377": bls_runs, "bls12_381": b381_runs,
                    "stagewise": sw_runs, "kernel_ids": ids,
                    "ntt_kernels": ntt_res, "bls_msm": bls_runs_msm,
                    "bls_msm_counts": bls_counts_msm,
                    "bls_kernels": bls_res,
                    "bn254_registers_differ": bn254_registers,
                    "stages": stages, "busy": busy, "point_api": point_api,
                    "point_ops_variants": res["point_ops_variants"],
                    "small_ntt_passes": {
                        key: res[f"small_ntt_{key}"]
                        for key, *_ in SMALL_NTT_PASSES[1:]},
                    "dft_k4": res["dft_k4"], "msm_2_20_shapes": res20,
                    "dg3_by_R": dg3_by_r, "probe": probe_rows,
                    "phase_a_layout": layout,
                    "array_msm": [*arr_runs, arr_381],
                    "point_helpers": helpers, "big_msm": big_runs,
                    "chunks_vs_groups": chunk_groups, "msm_host": host_runs,
                    "zero_root": zero_root, "sharded": sharded,
                    "ranking": ranking, "top_of_range": top,
                    "point_ops_shapes": point_ops_shapes,
                    "ptxas": usage, "phase_s": phase_s,
                    "card": card}))
    log(f"[done] chip_smoke.py took {time.perf_counter() - t_start:.1f} s "
        "after its imports")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
