#!/usr/bin/env python3
"""Smoke run of panda_tpu_torch on one CUDA device.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. environment: torch, CUDA, nvcc, the card's name and power limit;
2. build the five CUDA kernels from panda_tpu_torch/csrc;
3. each kernel against its plain PyTorch version on the card, at the MSM
   main path's shapes for n points (c = 13, W = 20, D = 4096 at n = 2^16):
   exact equality for the digits and the histogram, point equality for the
   point ops, phase A (through the bucket tables it yields) and the weighted
   scan; times from CUDA events, median of a few runs;
4. the slice: a PandaManager on cuda:0 with cached BN254 bases, then
   api.msm_bn254_with_cached_bases at n = 2^16 and 2^20, every call held to
   the pool-aggregated big-integer oracle; median, min and max host wall
   time of 20 calls; the launch counters of all five kernels must be > 0;
5. where the time goes: the same call run stage by stage with a device
   synchronise around each stage, median, min and max of 10 calls;
6. the device's busy share of one call, from torch.profiler.

The second-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.  Inputs come from fixed seeds.
"""

from __future__ import annotations

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


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    import torch
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def word_err(a, b) -> int:
    """Max absolute difference of two word tensors read as uint32."""
    import torch
    u = lambda t: t.to(torch.int64) & 0xFFFFFFFF
    return int((u(a) - u(b)).abs().max().item()) if a.numel() else 0


def pool_inputs(curve, n: int, seed: int, oracle: bool = True):
    """Pool-structured MSM inputs: <= 1024 distinct random points and a
    pool of full-range scalars, indexed by numpy draws.  Returns the bases
    and scalar blobs and the pool-aggregated oracle result (None when
    ``oracle`` is False)."""
    from panda_tpu.reference import curve_ref
    from panda_tpu_torch.fields import mont
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


def kernel_checks(curve, n: int, device) -> dict:
    """Phase 3: each kernel against its plain version at the main-path
    shapes for n points.  Returns {kernel: {max_abs_err, ms, plain_ms}}."""
    import torch
    from panda_tpu_torch.curves import point as cp
    from panda_tpu_torch.curves.point import AffinePoint, ProjPoint
    from panda_tpu_torch.ops import (digits, hist, msm, phase_a,
                                     point_kernels, reduce)
    from panda_tpu_torch.runtime.manager import PandaManager

    res = {}
    c = msm.window_bits((n - 1).bit_length())
    W = msm.signed_window_count(curve.fr.bits, c)
    D = 1 << (c - 1)
    m = msm.default_lanes(n, W)
    log(f"[kernels] n={n} c={c} W={W} D={D} lanes={m}")
    bases, scalars, _ = pool_inputs(curve, n, 7, oracle=False)
    gm = PandaManager.new(0, curve, device=device)
    px, py = gm.ingest_bases(bases)
    s = gm.ingest_scalars(scalars)

    def record(name, err, ms, plain_ms, ok):
        log(f"[kernels] {name}: max_abs_err={err} kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with plain")
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # 1. signed digits: exact
    km, kn = digits.signed_digits(curve.fr, s, c, W)
    pm, pn = digits.signed_digits_plain(curve.fr, s, c, W)
    err = max(word_err(km, pm), word_err(kn.int(), pn.int()))
    record("digits", err,
           cuda_ms(lambda: digits.signed_digits(curve.fr, s, c, W), 5),
           cuda_ms(lambda: digits.signed_digits_plain(curve.fr, s, c, W), 3),
           torch.equal(km, pm) and torch.equal(kn, pn))

    # 2. histogram of the digits: exact
    kh, ph = hist.hist_counts(km, D), hist.hist_counts_plain(km, D)
    record("hist", word_err(kh, ph),
           cuda_ms(lambda: hist.hist_counts(km, D), 5),
           cuda_ms(lambda: hist.hist_counts_plain(km, D), 3),
           torch.equal(kh, ph))

    # 3. phase A, through the bucket tables it yields
    st = msm.sorted_streams(km, kn, c, m)
    ka = phase_a.scan(curve, st.keys, st.sidx, px, py, D + 1)
    pa = phase_a.scan_plain(curve, st.keys, st.sidx, px, py, D + 1)
    kb = msm.assemble_buckets(curve, st, *ka)
    pb = msm.assemble_buckets(curve, st, *pa)
    ok = bool(cp.eq(curve, kb, pb).all()) and torch.equal(ka[0], pa[0]) \
        and torch.equal(ka[2], pa[2])
    err = max(word_err(a, b) for a, b in zip(kb, pb))
    record("phase_a", err,
           cuda_ms(lambda: phase_a.scan(curve, st.keys, st.sidx, px, py,
                                        D + 1), 5),
           cuda_ms(lambda: phase_a.scan_plain(curve, st.keys, st.sidx, px,
                                              py, D + 1), 2), ok)

    # 4. point ops on the bucket tables' shape (8, W, D): the interior +
    #    tail add, a mixed add of bases, a doubling
    q = ProjPoint(*(a.flip(-1).contiguous() for a in kb))
    idx = torch.arange(W * D, device=device).reshape(W, D) % px.shape[1]
    qa = AffinePoint(px[:, idx], py[:, idx])
    errs, oks, kms, pms = [], [], [], []
    for kf, pf, args in ((point_kernels.padd, cp.add_plain, (kb, q)),
                         (point_kernels.pmadd, cp.madd_plain, (kb, qa)),
                         (point_kernels.pdbl, cp.dbl_plain, (kb,))):
        kr, pr = kf(curve, *args), pf(curve, *args)
        oks.append(bool(cp.eq(curve, kr, pr).all()))
        errs.append(max(word_err(a, b) for a, b in zip(kr, pr)))
        kms.append(cuda_ms(lambda: kf(curve, *args), 5))
        pms.append(cuda_ms(lambda: pf(curve, *args), 3))
    log(f"[kernels] point_ops padd/pmadd/pdbl kernel ms {kms}, plain ms {pms}")
    record("point_ops", max(errs), kms[0], pms[0], all(oks))

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
    record("wscan", err,
           cuda_ms(lambda: point_kernels.weighted_scan(curve, cols), 5),
           cuda_ms(lambda: point_kernels.weighted_scan_plain(curve, cols), 3),
           ok)
    return res


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


def device_busy(sl: dict, unprofiled_ms: float) -> dict:
    """Phase 6: one byte-API call under torch.profiler.  Busy time is the
    union of the device intervals (kernels and copies; the profiler's own
    buffer requests left out); the share is given over the profiled call's
    wall time and over the unprofiled median of phase 4."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from panda_tpu_torch.runtime import api
    gm, scalars = sl["gm"], sl["scalars"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        blob = api.msm_bn254_with_cached_bases(gm, scalars, 0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if blob != sl["want"]:
        raise AssertionError("profiled call: blob != oracle")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "Activity Buffer" not in e.name)
    busy, end = 0.0, None
    for a, b in spans:                       # union of intervals, in us
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy /= 1e3
    if busy <= 0:
        raise AssertionError("torch.profiler recorded no device activity")
    top = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0
                  and "Activity Buffer" not in e.key),
                 key=lambda e: -e.self_device_time_total)[:8]
    log(f"[busy 2^{sl['log_n']}] device busy {busy:.3f} ms; profiled wall "
        f"{wall:.3f} ms (share {busy / wall:.3f}); unprofiled median "
        f"{unprofiled_ms:.3f} ms (share {busy / unprofiled_ms:.3f})")
    for e in top:
        log(f"  {e.key[:60]:<60} {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count}")
    return {"log_n": sl["log_n"], "busy_ms": busy, "profiled_wall_ms": wall,
            "share_profiled": busy / wall,
            "share_unprofiled": busy / unprofiled_ms}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from panda_tpu.curves.config import BN254
    from panda_tpu_torch.ops import _ext

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
    log(f"[build] five kernels in {_ext.build_all():.1f} s")

    # 3. kernels against their plain versions
    res = kernel_checks(BN254, 1 << 16, device)

    # 4. the slice: the main path, counted
    sizes = [slice_inputs(BN254, k, device) for k in (16, 20)]
    _ext.reset_counts()
    runs = [slice_run(sl, card, 20) for sl in sizes]
    counts = dict(_ext.launches)
    log(f"[slice] kernel launches: {counts}")
    dead = [k for k, v in counts.items() if v == 0]
    if dead:
        raise AssertionError(f"kernels never launched on the main path: {dead}")

    # 5. where the time goes, 6. device busy share (not counted)
    stages = [stage_breakdown(BN254, sl, 10) for sl in sizes]
    busy = [device_busy(sl, r["median_ms"]) for sl, r in zip(sizes, runs)]
    for sl in sizes:
        sl["gm"].deinit()

    replaces = {"digits": "panda_tpu/ops/digits_pallas.py:77",
                "hist": "panda_tpu/ops/hist_pallas.py:63",
                "phase_a": "panda_tpu/ops/phase_a_pallas.py:257",
                "point_ops": "panda_tpu/ops/point_pallas.py:48",
                "wscan": "panda_tpu/ops/point_pallas.py:167"}
    kernels = [{"name": k, "route": "cuda",
                "source": f"panda_tpu_torch/csrc/{k}.cu",
                "replaces": replaces[k], "launches": counts[k], **res[k]}
               for k in _ext.KERNELS]
    log(json.dumps({"slice": runs, "stages": stages, "busy": busy,
                    "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
