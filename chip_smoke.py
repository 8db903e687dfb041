#!/usr/bin/env python3
"""Smoke run of panda_tpu_torch on one CUDA device.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. environment: torch, CUDA, nvcc, the card's name and power limit;
2. build the nine CUDA kernels from panda_tpu_torch/csrc, in parallel,
   and log each kernel entry's registers and spills (ptxas -v);
3. each kernel against its plain PyTorch version on the card, at its main
   path's shapes: the five MSM kernels at n = 2^16 points (c = 13, W = 20,
   D = 4096) and at n = 2^20 (c = 16, W = 16, D = 32768): exact equality
   for the digits and the histogram, point equality for the point ops,
   phase A (through the bucket tables it yields, its keys and tails) and
   the weighted scan; fmul at (8, 2^20), the DFT at K = 32, nb = 2^15 (the
   four-step 2^20 NTT's passes), forward and with the inverse's scale and
   the canonical pass, and at K = 4, nb = 2^20 (the 2^22 NTT's leaf), and
   the radix-2 pass small_ntt at K = 256, nb = 2^12 with its T1 table and
   at K = 64, nb = 2^14 (the radix-2 2^20 NTT's passes), forward and with
   the inverse's scale and the canonical store, on words that include
   values >= 2r: equal words, for BN254 Fr and BLS12-377 Fr; the gather
   probe's dg3 at its four depths R = 8, 32, 256 and 1024 (G = 2^22 /
   (128 R)): equal words (the kernels line gives R = 8's times).  Each
   kernel's device time a launch (the median of torch.profiler's CUDA
   kernel records over a batch of calls) and the batch's time from CUDA
   events, beside the least time the card could take (bytes over 3.35
   TB/s or operations over the peak rate, the larger) and, where one
   PyTorch call computes the same function, that call's time
   (torch._int_mm beside the DFT as a yardstick of the int8 tensor cores,
   torch.gather beside dg3).  The BLS12-381 NTT and a BLS12-377 MSM on the
   card raise NotImplementedError;
4. the main paths, each with every launch counter set to 0 just before it
   and read after it (each of its kernels must have launched): the MSM
   slice, api.msm_bn254_with_cached_bases at n = 2^16 and 2^20 with cached
   bases, every call held to the pool-aggregated big-integer oracle, host
   wall time of 20 calls; the NTT byte API with the four-step engine
   (PANDA_NTT_IMPL=auto): api.ntt_bn254, api.intt and api.ntt_bn254_v1 (a
   non-default root) at 2^20 and 2^22, held to a bit-exact INTT roundtrip
   and 4 big-integer spot checks each, and at 2^12 to the NTT oracle byte
   for byte; 20 timed calls (10 at 2^22) and the device time of run_ntt
   alone; the same with the radix-2 engine (PANDA_NTT_IMPL=pallas), whose
   bytes must equal the four-step engine's, and whose steady 2^20 call
   must launch small_ntt and no dft; the BLS12-377 NTT with both engines,
   at 2^12 against the oracle and at 2^20 (roundtrip, spot checks, 10
   timed calls); the gather probe (tools/profile_gather4.py's port,
   panda_tpu_torch.tools.profile_gather4.main) at its full sizes, whose
   dg3 cases must launch dg3, and then one measurement beside it: 2^24
   lookups of a base point in phase A's own layout (index_select from the
   (8, 2^20) word tensors of the 2^20 MSM session), beside the probe's
   R = 16 row gather and phase A's device ms a launch at 2^20;
5. where the time goes: the MSM call (both sizes) and the 2^20 NTT call of
   each engine run stage by stage with a device synchronise around each
   stage, median, min and max of 10 calls;
6. the device's busy share of one call each (MSM 2^16 and 2^20, NTT 2^20
   and 2^22 with each engine), and each kernel's launches and device ms in
   that call, from torch.profiler.

The second-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.  Inputs come from fixed seeds.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np


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
    ``nvcc -Xptxas=-v`` on each source with the build's flags (a cubin
    under build/, all sources at once).  Returns {source: [(entry,
    registers, stack, spill stores, spill loads)]}."""
    import re
    from concurrent.futures import ThreadPoolExecutor
    from panda_tpu_torch.ops import _ext
    out_dir = _ext.BUILD / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _ext.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                      "-fPIC")]

    def one(name):
        res = subprocess.run(
            [_ext.nvcc(), *flags, "-cubin", "-Xptxas=-v", "-o",
             str(out_dir / f"{name}.cubin"), str(_ext.CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas=-v failed for {name}.cu:\n"
                               f"{res.stderr}")
        rows, entry, frame = [], None, (0, 0, 0)
        for line in res.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                          r" (\d+) bytes spill loads", line)
            if m:
                frame = tuple(int(v) for v in m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                rows.append((entry, int(m.group(1)), *frame))
                entry, frame = None, (0, 0, 0)
        return name, rows

    with ThreadPoolExecutor(len(_ext.KERNELS)) as ex:
        return dict(ex.map(one, _ext.KERNELS))


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
    profiler session and fills in the median device ms a launch."""

    def __init__(self):
        self.jobs = []

    def add(self, fn, reps: int, names, out: dict) -> None:
        self.jobs.append((fn, reps, names, out))

    def take(self) -> None:
        def batch(fn, reps):
            def run():
                for _ in range(reps):
                    fn()
            return run

        jobs = []
        for i, (fn, reps, names, out) in enumerate(self.jobs):
            jobs += [(f"chip_smoke warm-up {i}", fn),
                     (f"chip_smoke batch {i}", batch(fn, reps))]
        _, events, ranges = profile_ranges(jobs)
        for i, (fn, reps, names, out) in enumerate(self.jobs):
            us = kernel_records(events, names, ranges[f"chip_smoke batch {i}"])
            if not us:
                raise AssertionError(f"the profiler recorded no launch of "
                                     f"{names} in batch {i}")
            out["ms"] = statistics.median(us) / 1e3
            out["recorded"] = f"{len(us)} of {reps}"
        self.jobs = []


def word_err(a, b) -> int:
    """Max absolute difference of two word tensors read as uint32."""
    import torch
    u = lambda t: t.to(torch.int64) & 0xFFFFFFFF
    return int((u(a) - u(b)).abs().max().item()) if a.numel() else 0


# Peak rates of one H100 SXM at its full 700 W limit.  Memory and int8
# tensor cores: NVIDIA's H100 data sheet.  32-bit
# integer multiply-add: 64 per SM per clock (Hopper architecture white
# paper) x 132 SMs x 1.98 GHz boost; every CIOS multiply is 264 of them
# (8 x (16 + 1 + 16)), and the lo and hi halves count separately.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
IMAD_PER_S = 64 * 132 * 1.98e9
MONT_MUL_IMADS = 264


def bound(nbytes: float, ops: float, rate: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def pool_inputs(curve, n: int, seed: int, oracle: bool = True):
    """Pool-structured MSM inputs: <= 1024 distinct random points and a
    pool of full-range scalars, indexed by numpy draws.  Returns the bases
    and scalar blobs and the pool-aggregated oracle result (None when
    ``oracle`` is False)."""
    from panda_tpu_torch.fields import mont
    from panda_tpu_torch.reference import curve_ref
    fp, fr = curve.fp, curve.fr
    rng = random.Random(seed)
    npr = np.random.default_rng(seed)
    pts = [curve_ref.random_point(curve, rng) for _ in range(min(n, 1024))]
    svals = [rng.randrange(fr.modulus) for _ in range(min(n, 1 << 16))]
    pidx = npr.integers(len(pts), size=n)
    sidx = npr.integers(len(svals), size=n)
    xw = mont.ints_to_words(fp, [fp.to_wire_int(x) for x, _ in pts])
    yw = mont.ints_to_words(fp, [fp.to_wire_int(y) for _, y in pts])
    sw = mont.ints_to_words(fr, [fr.to_wire_int(s) for s in svals])
    xy = np.stack([xw[:, pidx].T, yw[:, pidx].T], axis=1)    # (n, 2, 8)
    bases = np.ascontiguousarray(xy).astype("<u4").tobytes()
    scalars = np.ascontiguousarray(sw[:, sidx].T).astype("<u4").tobytes()
    if not oracle:
        return bases, scalars, None
    agg = [0] * len(pts)
    for p, s in zip(pidx.tolist(), sidx.tolist()):
        agg[p] += svals[s]
    agg = [a % fr.modulus for a in agg]
    return bases, scalars, curve_ref.msm_oracle(curve, pts, agg)


def kernel_checks(curve, n: int, device, timer: DeviceTimes,
                  plain_times: bool = True) -> dict:
    """Phase 3: each kernel against its plain version at the main-path
    shapes for n points.  Returns {kernel: {max_abs_err, batch_ms (CUDA
    events around a batch), plain_ms (None unless ``plain_times``),
    bound_ms, bound_by, library_ms}}; ``timer`` fills in "ms", the device
    ms a launch, when it takes its batches."""
    import torch
    from panda_tpu_torch.curves import point as cp
    from panda_tpu_torch.curves.point import AffinePoint, ProjPoint
    from panda_tpu_torch.ops import (digits, hist, msm, phase_a,
                                     point_kernels, reduce)
    from panda_tpu_torch.runtime.manager import PandaManager

    res = {}
    imad = lambda muls: muls * MONT_MUL_IMADS            # noqa: E731
    c = msm.window_bits((n - 1).bit_length())
    W = msm.signed_window_count(curve.fr.bits, c)
    D = 1 << (c - 1)
    m = msm.default_lanes(n, W)
    log(f"[kernels] n={n} c={c} W={W} D={D} lanes={m}")
    bases, scalars, _ = pool_inputs(curve, n, 7, oracle=False)
    gm = PandaManager.new(0, curve, device=device)
    px, py = gm.ingest_bases(bases)
    s = gm.ingest_scalars(scalars)

    def timed(fn, reps, names):
        """A kernel call's batch ms now; its device ms a launch queued."""
        out = {"batch_ms": cuda_ms(fn, reps)}
        timer.add(fn, reps, names, out)
        return out

    def plain_ms(fn, reps):
        return cuda_ms(fn, reps) if plain_times else None

    def record(name, err, ms, plain, ok, bnd, library_ms=None):
        log(f"[kernels 2^{n.bit_length() - 1}] {name}: max_abs_err={err} "
            f"kernel {ms['batch_ms']:.4f} ms batch-timed, plain {plain} ms, "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), library "
            f"{library_ms} ms")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with plain")
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
           bound(n * 32 + W * n * 5, imad(n), IMAD_PER_S))

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

    # 3. phase A, through the bucket tables it yields (its emissions are
    #    defined where a run ended); the work this data needs is one mixed
    #    add per entry with a digit in 1..D, and a stored sum per run end
    st = msm.sorted_streams(km, kn, c, m)
    live = int(((st.keys >= 1) & (st.keys <= D)).sum().item())
    P = st.keys.numel()
    ka = phase_a.scan(curve, st.keys, st.sidx, px, py, D + 1)
    pa = phase_a.scan_plain(curve, st.keys, st.sidx, px, py, D + 1)
    kb = msm.assemble_buckets(curve, st, *ka)
    pb = msm.assemble_buckets(curve, st, *pa)
    ok = bool(cp.eq(curve, kb, pb).all()) and torch.equal(ka[0], pa[0]) \
        and torch.equal(ka[2], pa[2])
    err = max(word_err(a, b) for a, b in zip(kb, pb))
    runs = int((ka[0] != D + 1).sum().item())
    log(f"[kernels 2^{n.bit_length() - 1}] phase_a: {W} windows x {m} lanes "
        f"x {st.keys.shape[1]} steps in one launch; {live} mixed adds, "
        f"{runs} run sums stored")
    record("phase_a", err,
           timed(lambda: phase_a.scan(curve, st.keys, st.sidx, px, py,
                                      D + 1), 5, KERNEL_NAMES["phase_a"]),
           plain_ms(lambda: phase_a.scan_plain(curve, st.keys, st.sidx, px,
                                               py, D + 1), 1), ok,
           bound(P * 12 + px.shape[1] * 64 + runs * 96 + W * m * 100,
                 imad(11 * live), IMAD_PER_S))

    # 4. point ops on the bucket tables' shape (8, W, D): the interior +
    #    tail add, a mixed add of bases, a doubling
    q = ProjPoint(*(a.flip(-1).contiguous() for a in kb))
    idx = torch.arange(W * D, device=device).reshape(W, D) % px.shape[1]
    qa = AffinePoint(px[:, idx], py[:, idx])
    # bounds: (words in + out) x 32 bytes and the multiplies per element:
    # padd 6 + 3 words, 12M; pmadd 5 + 3, 11M; pdbl 3 + 3, 8M (6M + 2S)
    N = W * D
    errs, oks, kms, pms, bnds = [], [], [], [], []
    for kf, pf, args, fes, muls, kname in (
            (point_kernels.padd, cp.add_plain, (kb, q), 9, 12, "padd_kernel"),
            (point_kernels.pmadd, cp.madd_plain, (kb, qa), 8, 11,
             "pmadd_kernel"),
            (point_kernels.pdbl, cp.dbl_plain, (kb,), 6, 8, "pdbl_kernel")):
        kr, pr = kf(curve, *args), pf(curve, *args)
        oks.append(bool(cp.eq(curve, kr, pr).all()))
        errs.append(max(word_err(a, b) for a, b in zip(kr, pr)))
        kms.append(timed(lambda kf=kf, args=args: kf(curve, *args), 20,
                         (kname,)))
        pms.append(plain_ms(lambda: pf(curve, *args), 2))
        bnds.append(bound(fes * 32 * N, imad(muls * N), IMAD_PER_S))
    log(f"[kernels 2^{n.bit_length() - 1}] point_ops padd/pmadd/pdbl on "
        f"{N} elements: batch ms {[k['batch_ms'] for k in kms]}, plain ms "
        f"{pms}, bounds {bnds}")
    res["point_ops_variants"] = {"kernel_ms": kms, "plain_ms": pms,
                                 "bounds": bnds}
    record("point_ops", max(errs), kms[0], pms[0], all(oks), bnds[0])

    # 5. weighted scan on the bucket tables, split as weighted_window_sum does
    batch = W
    lanes, steps = reduce.lane_split(batch, D)
    cols = ProjPoint(*(a.reshape(8, batch, lanes, steps).permute(0, 3, 1, 2)
                       .reshape(8, steps, batch * lanes).contiguous()
                       for a in kb))
    kr, kw = point_kernels.weighted_scan(curve, cols)
    pr, pw = point_kernels.weighted_scan_plain(curve, cols)
    ok = bool(cp.eq(curve, kr, pr).all()) and bool(cp.eq(curve, kw, pw).all())
    err = max(word_err(a, b) for a, b in zip((*kr, *kw), (*pr, *pw)))
    S, N = cols.x.shape[1:]
    log(f"[kernels 2^{n.bit_length() - 1}] wscan: {S} steps x {N} columns")
    record("wscan", err,
           timed(lambda: point_kernels.weighted_scan(curve, cols), 10,
                 KERNEL_NAMES["wscan"]),
           plain_ms(lambda: point_kernels.weighted_scan_plain(curve, cols), 1),
           ok, bound(3 * 32 * S * N + 6 * 32 * N, imad(24 * S * N),
                     IMAD_PER_S))
    return res


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


def ntt_kernel_checks(fr, log_n: int, device,
                      timer: DeviceTimes | None) -> dict:
    """Phase 3 for the NTT's kernels at the 2^log_n NTT's shapes, over the
    field ``fr``: fmul on (8, 2^log_n) (the top level's twiddle product: a
    DFT output < 2r times the table < r), the DFT at K = 32,
    nb = 2^(log_n - 5) (every pass of the four-step 2^20), forward and
    with the inverse's n^-1 scale and the canonical pass, and the radix-2
    pass small_ntt at two of the radix-2 engine's shapes (at 2^20: K = 256,
    nb = 2^12 with its T1 table, the top pass; K = 64, nb = 2^14, the
    leaf, whose shape the middle pass shares), each in the main path's
    configuration and in one with the inverse's scale, the canonical store
    and input words >= 2r reduced at load; and the DFT at K = 4,
    nb = 2^log_n (the four-step 2^(log_n + 2) NTT's leaf).  Kernel and
    plain version must give equal words.  Times (``timed``) at the main
    path's configuration (given a ``timer``, which fills in the device ms a
    launch) beside the batch time: small_ntt's entry is the top pass, its
    leaf's entry small_ntt_k64, the DFT's K = 4 entry dft_k4, and the
    torch._int_mm yardstick (the same M x K x N in signed int8, no
    reduction) is logged beside the DFT."""
    import torch
    from panda_tpu_torch.ops import fmul, ntt_fused, ntt_pallas
    res = {}
    n, r = 1 << log_n, fr.modulus
    below_r, below_2r = r >> 224, (2 * r) >> 224
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

    a = random_words(n, 31, below_2r).to(device)              # < 2r
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

    scale = const_words(fr, pow(n, -1, r), device)
    errs, timing = [], {}
    for log_k, with_pre in ((8, True), (6, False)):
        K, nb = 1 << log_k, 1 << (log_n - log_k)
        tw = ntt_pallas.stage_twiddle_rows(fr, log_k, fr.root_of_unity(log_k),
                                           device)
        pre = random_words(K * nb, 34, below_r).reshape(8, K, nb).to(device) \
            if with_pre else None
        lazy = random_words(K * nb, 35, below_2r).reshape(8, K, nb).to(device)
        wide = random_words(K * nb, 36).reshape(8, K, nb).to(device)
        # (input, pre table, scale, reduce_in, canonical_out): the main
        # path's configuration first, the top pass (lazy input, table,
        # canonical store) or the leaf (any words, reduced at load)
        main = (lazy, pre, None, False, True) if with_pre else \
            (wide, None, None, True, False)
        other = (wide, pre, scale, True, True) if with_pre else \
            (lazy, None, scale, False, True)
        for xi, *opts in (main, other):
            k = ntt_pallas.small_ntt_batch(fr, xi, log_k, tw, *opts)
            p = ntt_pallas.small_ntt_batch_plain(fr, xi, log_k, tw, *opts)
            errs.append(word_err(k, p))
            if not torch.equal(k, p):
                raise AssertionError(f"small_ntt ({fr.name}) K = {K}: kernel "
                                     "disagrees with plain")
        if timer is not None:
            xi, *opts = main
            muls = nb * ((log_k - 1) * K // 2 + (K if with_pre else 0))
            nbytes = 2 * 32 * K * nb + 32 * K * (1 + (nb if with_pre else 0))
            run = lambda xi=xi, log_k=log_k, tw=tw, opts=opts: (  # noqa
                ntt_pallas.small_ntt_batch(fr, xi, log_k, tw, *opts))
            timing[K] = {
                "batch_ms": cuda_ms(run, 20),
                "plain_ms": cuda_ms(lambda: ntt_pallas.small_ntt_batch_plain(
                    fr, xi, log_k, tw, *opts), 2),
                **bound(nbytes, muls * MONT_MUL_IMADS, IMAD_PER_S)}
            timer.add(run, 20, KERNEL_NAMES["small_ntt"], timing[K])
            log(f"{tag} small_ntt K = {K}, nb = {nb}"
                f"{' + T1 table' if with_pre else ''}: {timing[K]}")
    log(f"{tag} small_ntt: max_abs_err={max(errs)}")
    if timer is not None:
        res["small_ntt"] = timing[256]
        res["small_ntt"].update({"max_abs_err": max(errs),
                                 "library_ms": None})
        res["small_ntt_k64"] = timing[64]
    return res


def gather_checks(device, timer: DeviceTimes) -> dict:
    """Phase 3 for dg3 at the gather probe's shapes: R = 8, 32, 256 and 1024
    with G = 2^22 / (128 R), tables and indices drawn as the probe draws
    them.  Kernel and plain version must give equal words.  Returns per R:
    max_abs_err, batch ms, plain ms, bound (the table, indices and output,
    4 bytes each a lookup) and torch.gather's ms on int64 indices converted
    before the timing; ``timer`` fills in the device ms a launch."""
    import torch
    from panda_tpu_torch.tools import profile_gather4 as pg
    g = torch.Generator(device=device).manual_seed(4)
    by_r = {}
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
            "library_ms": cuda_ms(lambda: torch.gather(tab, 1, idx64), 20)}
        timer.add(lambda tab=tab, idx=idx: pg.dg3(tab, idx), 20,
                  KERNEL_NAMES["dg3"], row)
        log(f"[kernels] dg3 R = {R}, G = {G}: {row}")
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


def bls_raises(device) -> None:
    """What the kernels do not cover raises NotImplementedError on the card
    (no plain version runs for a CUDA tensor): the BLS12-381 NTT, and a
    BLS12-377 MSM."""
    from panda_tpu_torch import InitUnitType, PandaManager
    from panda_tpu_torch.runtime import api
    for what, run in (
            ("BLS12-381 NTT", lambda: api.ntt_bls12_381(
                PandaManager.init_all(0, InitUnitType.NTT, curve="bls12_381",
                                      device=device), bytes(32 * 32), 5)),
            ("BLS12-377 MSM", lambda: api.msm(
                PandaManager.new(0, "bls12_377", device=device),
                bytes(32 * 16), bytes(96 * 16)))):
        try:
            run()
        except NotImplementedError as e:
            log(f"[kernels] {what} on the card raises: {e}")
            continue
        raise AssertionError(f"{what} ran on the card")


def slice_inputs(curve, log_n: int, device) -> dict:
    """A PandaManager on ``device`` with the cached bases of a pool-structured
    input at n = 2^log_n, the scalar bytes and the oracle's result blob."""
    from panda_tpu_torch import InitUnitType, PandaManager
    n = 1 << log_n
    t0 = time.perf_counter()
    bases, scalars, exp = pool_inputs(curve, n, 20260816 + log_n)
    fp = curve.fp
    want = b"".join(fp.to_wire_int(v).to_bytes(fp.n_bytes, "little")
                    for v in ((*exp, 1) if exp is not None else (0, 1, 0)))
    log(f"[slice 2^{log_n}] inputs + oracle {time.perf_counter() - t0:.1f} s")
    gm = PandaManager.init_all(0, InitUnitType.MSM, [bases], curve=curve,
                               device=device)
    gm.sync()
    return {"log_n": log_n, "n": n, "gm": gm, "scalars": scalars,
            "want": want}


def spread(ms: list) -> dict:
    return {"median_ms": statistics.median(ms), "min_ms": min(ms),
            "max_ms": max(ms)}


def slice_run(sl: dict, card: str, reps: int) -> dict:
    """Phase 4 at one size: byte-API MSM with cached bases, every call held
    to the oracle; host wall time of ``reps`` steady-state calls, with the
    calling thread's CPU time per call and the garbage collector's pauses,
    so a slow call shows whether the host thread worked, waited or
    collected."""
    import gc
    import torch
    from panda_tpu_torch.runtime import api
    gm, scalars, want, log_n = sl["gm"], sl["scalars"], sl["want"], sl["log_n"]
    t0 = time.perf_counter()
    blob = api.msm_bn254_with_cached_bases(gm, scalars, 0)
    first = time.perf_counter() - t0
    if blob != want:
        raise AssertionError(f"MSM 2^{log_n}: blob != oracle")
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
            blob = api.msm_bn254_with_cached_bases(gm, scalars, 0)
            times.append((time.perf_counter() - t0) * 1e3)
            cpu.append((time.thread_time() - c0) * 1e3)
            if blob != want:
                raise AssertionError(f"MSM 2^{log_n}: repeat blob != oracle")
    finally:
        gc.callbacks.remove(on_gc)
    s, sc = spread(times), spread(cpu)
    log(f"[slice 2^{log_n}] oracle-exact; first call {first:.3f} s, steady "
        f"ms/call over {reps} calls: median {s['median_ms']:.2f}, min "
        f"{s['min_ms']:.2f}, max {s['max_ms']:.2f}; "
        f"{sl['n'] / s['median_ms'] * 1e3:.0f} points/s at the median on "
        f"{card}")
    log(f"[slice 2^{log_n}] host thread CPU ms/call: median "
        f"{sc['median_ms']:.2f}, min {sc['min_ms']:.2f}, max "
        f"{sc['max_ms']:.2f}; garbage collection {gc_ms[0]:.2f} ms over "
        f"{reps} calls")
    return {"log_n": log_n, "first_s": first, **s,
            "points_per_s": sl["n"] / s["median_ms"] * 1e3, "calls_ms": times,
            "cpu_ms": cpu, "gc_ms": gc_ms[0]}


STAGES = ("ingest: bytes to words (host)", "ingest: copy to device",
          "digits kernel", "sort + run ends (hist kernel)", "phase A kernel",
          "bucket assembly", "weighted reduction", "host Horner + blob")


def stage_breakdown(curve, sl: dict, reps: int) -> dict:
    """Phase 5: the byte-API call of phase 4 run stage by stage, with a
    device synchronise around each stage (host clock).  The stages call
    the functions api._msm_run reaches, in its order; the result is held
    to the oracle.  Returns per-stage {median_ms, min_ms, max_ms} over
    ``reps`` calls and the kernel launches of one call."""
    import torch
    from panda_tpu_torch.curves.point import ProjPoint
    from panda_tpu_torch.fields import mont
    from panda_tpu_torch.ops import _ext, msm, phase_a
    from panda_tpu_torch.ops import reduce as red
    gm, log_n, n = sl["gm"], sl["log_n"], sl["n"]
    px, py = gm.d_bases[0]
    c = msm.window_bits(log_n, bits=curve.fr.bits)
    W = msm.signed_window_count(curve.fr.bits, c)
    wg = msm._window_group_size(n, W)
    m = msm.default_lanes(n, wg)
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
        parts = []
        for g in range(0, W, wg):
            st = timed(STAGES[3], msm.sorted_streams, mags[g:g + wg],
                       negs[g:g + wg], c, m)
            em = timed(STAGES[4], phase_a.scan, curve, st.keys, st.sidx, px,
                       py, st.D + 1)
            b = timed(STAGES[5], msm.assemble_buckets, curve, st, *em)
            parts.append(timed(STAGES[6], red.weighted_window_sum, curve, b))
        blob = timed(STAGES[7], lambda: gm.format_affine_result(
            msm.host_horner(curve, ProjPoint(*(
                torch.cat([p[i] for p in parts], dim=1) for i in range(3))),
                c)))
        if blob != sl["want"]:
            raise AssertionError(f"stage breakdown 2^{log_n}: blob != oracle")
        for k in STAGES:
            rows[k].append(cur[k])
    totals = [sum(rows[k][i] for k in STAGES) for i in range(reps)]
    out = {k: spread(v) for k, v in rows.items()}
    out["total"] = spread(totals)
    log(f"[stages 2^{log_n}] c={c} W={W} groups={W // wg} lanes={m}; ms per "
        f"call over {reps} calls, synchronised stages (median / min / max):")
    for k, v in out.items():
        log(f"  {k:<34} {v['median_ms']:9.3f} {v['min_ms']:9.3f} "
            f"{v['max_ms']:9.3f}")
    log(f"  launches in one call: {dict(_ext.launches)}")
    return {"log_n": log_n, "stages": out, "launches": dict(_ext.launches)}


def device_busy(calls) -> list:
    """Phase 6: byte-API calls, each (label, call, wanted bytes, unprofiled
    median ms of phase 4), in one torch.profiler session, each in its own
    range.  Busy time is the union of the device intervals within a call's
    range (kernels and copies; the profiler's own buffer requests left
    out); the share is given over the call's wall time under the profiler
    and over the unprofiled median.  Per kernel library: its launches in
    the call (the launch counters) and their device ms in all."""
    import torch
    from torch.autograd import DeviceType
    from panda_tpu_torch.ops import _ext
    stats = []

    def job(call):
        def run():
            before = dict(_ext.launches)
            t0 = time.perf_counter()
            blob = call()
            torch.cuda.synchronize()
            stats.append({"wall": (time.perf_counter() - t0) * 1e3,
                          "launched": {k: _ext.launches[k] - before[k]
                                       for k in before}})
            return blob
        return run

    names = [f"chip_smoke call {label}" for label, *_ in calls]
    blobs, events, ranges = profile_ranges(
        [(n, job(call)) for n, (_, call, *_) in zip(names, calls)])
    out = []
    for name, (label, _, want, unprofiled_ms), blob, st in zip(
            names, calls, blobs, stats):
        if blob != want:
            raise AssertionError(f"profiled call {label}: wrong bytes")
        rng, wall = ranges[name], st["wall"]
        dev = [e for e in events
               if e.device_type == DeviceType.CUDA and e.name not in names
               and "Activity Buffer" not in e.name
               and rng.start <= (e.time_range.start + e.time_range.end) / 2
               <= rng.end]
        busy, end = 0.0, None
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in dev):    # union of intervals, in us
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        busy /= 1e3
        if busy <= 0:
            raise AssertionError(f"{label}: torch.profiler recorded no device "
                                 "activity")
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
    return {"bn254": api.ntt_bn254, "bls12_377": api.ntt_bls12_377}[
        curve.name]


def ntt_small_gate(curve, device, impls) -> None:
    """2^12, with each engine of ``impls``: forward and inverse bytes equal the big-int
    NTT oracle's, for inputs that include words >= r (any value below
    2^256 is taken)."""
    from panda_tpu_torch import InitUnitType, PandaManager
    from panda_tpu_torch.reference import ntt_ref
    from panda_tpu_torch.runtime import api
    fr = curve.fr
    log_n, p = 12, fr.modulus
    g = random.Random(12)
    words = [g.randrange(1 << 256) for _ in range(1 << log_n)]
    words[:3] = [p, p + 5, (1 << 256) - 1]
    data = b"".join(v.to_bytes(32, "little") for v in words)
    vals = [fr.from_wire_int(v) for v in words]
    w = fr.root_of_unity(log_n)
    wire = lambda vs: b"".join(fr.to_wire_int(v).to_bytes(32, "little")
                               for v in vs)                # noqa: E731
    want = (wire(ntt_ref.ntt_oracle(fr, vals, w)),
            wire(ntt_ref.intt_oracle(fr, vals, w)))
    for impl in impls:
        with ntt_engine(impl):
            gm = PandaManager.init_all(0, InitUnitType.NTT, curve=curve,
                                       device=device)
            got = (forward_alias(curve)(gm, data, log_n),
                   api.intt(gm, data, log_n))
        if got != want:
            raise AssertionError(f"{curve.name} NTT 2^12 ({ENGINES[impl]}) "
                                 "!= ntt_ref")
    log(f"[ntt {curve.name} 2^12] forward and inverse bytes equal ntt_ref "
        f"({', '.join(ENGINES[i] for i in impls)})")


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
    tag = f"[ntt {curve.name} {ENGINES[impl]} 2^{log_n}]"
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
        res = {"curve": curve.name, "engine": ENGINES[impl], "log_n": log_n,
               "first_s": first, "first_inverse_s": first_inv,
               "forward": ntt_timed(f"{curve.name} {ENGINES[impl]} forward "
                                    f"2^{log_n}",
                                    lambda: fwd(gm, data, log_n), out, reps,
                                    n, card),
               "inverse": ntt_timed(f"{curve.name} {ENGINES[impl]} inverse "
                                    f"2^{log_n}",
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
            y = radix2(level + 1, x.reshape(W, B, A * batch), False)
            z = timed("transposes", lambda: y.reshape(W, B, A, batch)
                      .permute(0, 2, 1, 3).contiguous())
            return timed(f"small_ntt level {level} (K = 2^{la}, T1 at load)"
                         f"{top}", ntt_pallas.small_ntt_batch, fr,
                         z.reshape(W, A, B * batch), la, tw, t1t, None, False,
                         canonical).reshape(W, A * B, batch)

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


REPLACES = {"digits": "panda_tpu/ops/digits_pallas.py:77",
            "hist": "panda_tpu/ops/hist_pallas.py:63",
            "phase_a": "panda_tpu/ops/phase_a_pallas.py:257",
            "point_ops": "panda_tpu/ops/point_pallas.py:48",
            "wscan": "panda_tpu/ops/point_pallas.py:167",
            "fmul": "panda_tpu/ops/point_pallas.py:251",
            "dft": "panda_tpu/ops/ntt_fused.py:83",
            "small_ntt": "panda_tpu/ops/ntt_pallas.py:130",
            "dg3": "tools/profile_gather4.py:78"}
MSM_KERNELS = ("digits", "hist", "phase_a", "point_ops", "wscan")
NTT_KERNELS = ("fmul", "dft")
RADIX2_KERNELS = ("small_ntt",)
BLS_KERNELS = ("fmul", "dft", "small_ntt")
PROBE_KERNELS = ("dg3",)


def gap_ranking(busy: list, bounds: dict) -> list:
    """Per call at 2^20 (the profiled MSM call and each engine's NTT call):
    each kernel's launches x (device ms a launch - its bound a launch at the
    2^20 shapes), largest first: where kernel work gains the most.  A
    kernel whose mean launch is shorter than that bound launches at smaller
    shapes (the point ops' scans) and is left out."""
    rows = []
    for b in busy:
        if "2^20" not in b["label"]:
            continue
        for k, v in b["per_kernel"].items():
            if not v["recorded"]:
                continue
            per_launch = v["device_ms"] / v["recorded"]
            if per_launch < bounds[k]:
                continue
            rows.append({"call": b["label"], "kernel": k,
                         "launches": v["launches"], "device_ms_a_launch":
                         per_launch, "gap_ms": v["launches"] *
                         (per_launch - bounds[k])})
    rows.sort(key=lambda r: -r["gap_ms"])
    log("[ranking] per call at 2^20, launches x (device ms - bound); dg3 is "
        "on no path of the system and is not ranked: " +
        "; ".join(f"{r['kernel']} ({r['call']}) {r['launches']} x "
                  f"{r['device_ms_a_launch']:.4f} ms, gap {r['gap_ms']:.3f} ms"
                  for r in rows))
    return rows


def counted(kernels, run):
    """Run one main path with every launch counter set to 0 just before it;
    fail unless each of ``kernels`` launched.  Returns (run's result,
    counts of every kernel)."""
    from panda_tpu_torch.ops import _ext
    _ext.reset_counts()
    out = run()
    counts = dict(_ext.launches)
    log(f"[slice] kernel launches: {counts}")
    dead = [k for k in kernels if counts[k] == 0]
    if dead:
        raise AssertionError(f"kernels never launched on the main path: {dead}")
    return out, counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from panda_tpu_torch.curves.config import BLS12_377, BN254
    from panda_tpu_torch.ops import _ext
    fr = BN254.fr

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

    # 2. build
    log(f"[build] {len(_ext.KERNELS)} kernels in {_ext.build_all():.1f} s")
    usage = ptxas_usage()
    log("[build] ptxas -v, registers / stack / spill stores / spill loads "
        "(bytes) a thread: " + "; ".join(
            f"{name} {entry[:40]} {regs} / {stack} / {st} / {ld}"
            for name, rows in usage.items()
            for entry, regs, stack, st, ld in rows))

    # 3. kernels against their plain versions (BN254 timed, BLS12-377
    #    checked); what the kernels do not cover raises on the card
    timer = DeviceTimes()
    res = kernel_checks(BN254, 1 << 16, device, timer)
    res20 = kernel_checks(BN254, 1 << 20, device, timer, plain_times=False)
    res.update(ntt_kernel_checks(fr, 20, device, timer))
    ntt_kernel_checks(BLS12_377.fr, 20, device, None)
    bls_raises(device)
    dg3_by_r = gather_checks(device, timer)
    timer.take()
    res["dg3"] = dict(dg3_by_r[8], max_abs_err=max(
        r["max_abs_err"] for r in dg3_by_r.values()))
    log("[kernels] device ms a launch (torch.profiler), batch ms a call, "
        "bound ms: " + "; ".join(
            f"{k}{tag} {v['ms']:.4f} ({v['recorded']}), {v['batch_ms']:.4f}, "
            f"{v['bound_ms']:.4f}"
            for tag, r in (("", res), (" 2^20", res20)) for k, v in r.items()
            if "ms" in v))

    # 4. the main paths, each counted on its own; a kernel's launches in
    #    the kernels line are its sum over the paths
    sizes = [slice_inputs(BN254, k, device) for k in (16, 20)]
    runs, counts = counted(MSM_KERNELS,
                           lambda: [slice_run(sl, card, 20) for sl in sizes])
    cases = [ntt_case(fr, k, 20261016 + k) for k in (20, 22)]
    bls_case = ntt_case(BLS12_377.fr, 20, 377)

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

    ntt_runs, ntt_counts = counted(NTT_KERNELS, four_step)
    r2_runs, r2_counts = counted(RADIX2_KERNELS, radix2)
    bls_runs, bls_counts = counted(BLS_KERNELS, bls12_377)

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
    for c in (ntt_counts, r2_counts, bls_counts, probe_counts):
        for k, v in c.items():
            counts[k] += v

    # 5. where the time goes, 6. device busy share (not counted)
    from panda_tpu_torch.runtime import api
    stages = [stage_breakdown(BN254, sl, 10) for sl in sizes]
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
        [(f"NTT 2^{cs['log_n']} {ENGINES[impl]}", ntt_call(cs, impl),
          cs["auto"]["out"], run["forward"]["median_ms"])
         for cs, r4, r2 in zip(cases, ntt_runs, r2_runs)
         for impl, run in (("auto", r4), ("pallas", r2))])
    for sl in sizes:
        sl["gm"].deinit()
    for cs in (*cases, bls_case):
        for impl in ENGINES:
            cs[impl]["gm"].deinit()

    # bounds a launch at the 2^20 shapes: the MSM kernels' from the 2^20
    # checks (point ops: padd on the bucket tables), fmul's and the DFT's
    # from the 2^20 NTT's passes, small_ntt's the mean over its three passes
    bounds = {k: res20[k]["bound_ms"] for k in MSM_KERNELS}
    bounds.update({k: res[k]["bound_ms"] for k in ("fmul", "dft")})
    bounds["small_ntt"] = (res["small_ntt"]["bound_ms"] +
                           2 * res["small_ntt_k64"]["bound_ms"]) / 3
    ranking = gap_ranking(busy, bounds)

    kernels = [{"name": k, "route": "cuda",
                "source": f"panda_tpu_torch/csrc/{k}.cu",
                "replaces": REPLACES[k], "launches": counts[k], **res[k]}
               for k in _ext.KERNELS]
    log(json.dumps({"slice": runs, "ntt": ntt_runs, "ntt_radix2": r2_runs,
                    "bls12_377": bls_runs, "stages": stages, "busy": busy,
                    "point_ops_variants": res["point_ops_variants"],
                    "small_ntt_k64": res["small_ntt_k64"],
                    "dft_k4": res["dft_k4"], "msm_2_20_shapes": res20,
                    "dg3_by_R": dg3_by_r, "probe": probe_rows,
                    "phase_a_layout": layout,
                    "ranking": ranking, "ptxas": usage,
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
