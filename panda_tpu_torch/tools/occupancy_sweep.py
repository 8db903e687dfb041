"""Builds of MSM phase A, of the weighted reduction, of the bucket
assembly, of the point ops, of the radix-2 NTT pass and of dg3, built and
timed on the card.

    python -m panda_tpu_torch.tools.occupancy_sweep \
        [phase_a|wscan|buckets|point_ops|small_ntt|dg3 ...]

Builds ``csrc/phase_a.cu``, ``csrc/wscan.cu``, ``csrc/buckets.cu``,
``csrc/point_ops.cu``, ``csrc/small_ntt.cu`` and ``csrc/dg3.cu`` (or those
named) with other ``-D`` flags (:data:`BUILDS`: the blocks an SM that the
launch bounds ask for, phase A's ring depth, the word counts for which the
weighted reduction overlaps its scaling with its tree; small_ntt's elements a
thread r, its threads a block (the columns a tile, T r / K) and blocks an
SM; dg3's words a slice (the columns or g a slice), narrowest column tile
and ring depth),
prints each build's registers, stack and spills from its ``ptxas -v``
report, and times each build with CUDA events over a few calls, with the
geometry each build's own occupancy gives (``phase_a.resident_threads``,
``reduce.wscan_threads``, ``msm.buckets_threads``,
``point_kernels.point_ops_threads``, ``ntt_pallas.small_ntt_threads``,
``profile_gather4.dg3_threads``).  The
MSM kernels at the MSM's 2^16 and 2^20 shapes for each curve, on 256 pool
scalars (a few hundred distinct digits a window); the bucket assembly
also on a uniform draw of scalars below r (near-uniform digits, as a
prover's scalars give), both on the default phase A's output.  The point
ops (padd, pmadd, pdbl and pdbl with k = c) on the MSM's bucket-table
shape (L, W, D) at 2^16 and 2^20 points for each curve, device ms a launch
beside its bound.  small_ntt
at the radix-2 2^20 and 2^22 NTTs' passes, each in the layout the
recursion hands it, for each scalar field, dg3 at the gather probe's four
depths.  Every build's bucket
tables and window sums must equal the default build's after affine
normalisation, every point_ops, small_ntt and dg3 build's words the plain
version's.
The first build of each kernel is the default.  Raises without a GPU.
"""

from __future__ import annotations

import json
import random
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..curves import point as cp
from ..curves.config import BLS12_377, BLS12_381, BN254
from ..fields import mont
from ..ops import _ext, msm, ntt_pallas, phase_a, point_kernels, reduce
from ..reference import curve_ref
from .bounds import IMAD_PER_S, bound, cios_imads

BLOCK = 128
# (kernel, nvcc defines), the default build of each kernel first
BUILDS = (
    ("phase_a", ()),
    ("phase_a", ("-DPTT_PHASE_A_BLOCKS_8=3", "-DPTT_PHASE_A_BLOCKS_12=2")),
    ("phase_a", ("-DPTT_PHASE_A_RING=2",)),
    ("phase_a", ("-DPTT_PHASE_A_RING=8",)),
    ("wscan", ()),
    ("wscan", ("-DPTT_WSCAN_BLOCKS=3",)),
    ("wscan", ("-DPTT_WSCAN_BLOCKS=4",)),
    ("wscan", ("-DPTT_WSCAN_OVERLAP_WORDS=8",)),     # overlap for every curve
    ("wscan", ("-DPTT_WSCAN_OVERLAP_WORDS=13",)),    # overlap for none
    ("buckets", ()),
    ("buckets", ("-DPTT_BUCKETS_BLOCKS_8=4", "-DPTT_BUCKETS_BLOCKS_12=3")),
    ("point_ops", ()),
    ("point_ops", ("-DPTT_PMADD_BLOCKS_8=4", "-DPTT_POINT_BLOCKS_12=3",
                   "-DPTT_PMADD_BLOCKS_12=3")),
    ("point_ops", ("-DPTT_POINT_BLOCKS_8=5", "-DPTT_PMADD_BLOCKS_8=5")),
    ("point_ops", ("-DPTT_POINT_BLOCKS_8=6", "-DPTT_PMADD_BLOCKS_8=6",
                   "-DPTT_POINT_BLOCKS_12=4", "-DPTT_PMADD_BLOCKS_12=4")),
    ("point_ops", ("-DPTT_POINT_BLOCKS_8=1", "-DPTT_POINT_BLOCKS_12=1",
                   "-DPTT_PMADD_BLOCKS_12=1")),
    ("small_ntt", ()),
    ("small_ntt", ("-DPTT_SMALL_NTT_R=4", "-DPTT_SMALL_NTT_BLOCKS=4")),
    ("small_ntt", ("-DPTT_SMALL_NTT_R=4", "-DPTT_SMALL_NTT_BLOCKS=3")),
    ("small_ntt", ("-DPTT_SMALL_NTT_BLOCKS=1",)),
    ("small_ntt", ("-DPTT_SMALL_NTT_THREADS=128", "-DPTT_SMALL_NTT_BLOCKS=4")),
    ("dg3", ()),
    ("dg3", ("-DPTT_DG3_MIN_COLS=8",)),
    ("dg3", ("-DPTT_DG3_SLICE_WORDS=4096",)),
    ("dg3", ("-DPTT_DG3_RING=3",)),
)
MSM_KERNELS = ("phase_a", "wscan", "buckets")
FIELD_STRUCT = {"bn254_fr": "Fr254", "bls12_377_fr": "Fr377",
                "bls12_381_fr": "Fr381"}
CURVE_STRUCT = {"bn254": "Bn254", "bls12_377": "Bls12_377",
                "bls12_381": "Bls12_381"}


def _ms(fn, reps: int) -> float:
    """Mean device ms a call over ``reps`` calls, after one warm-up."""
    fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _device_ms(fn, reps: int, kernel: str) -> float:
    """Median device ms of the launches of ``kernel`` over ``reps`` calls
    of ``fn`` after one warm-up, from torch.profiler's kernel records (a
    call shorter than its wrapper's host work is paced by the host under
    CUDA events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    if not us:
        raise AssertionError(f"the profiler recorded no {kernel} launch")
    return float(np.median(us)) / 1e3


def _inputs(curve, n: int, device, seed: int = 8):
    """Bases (L, n) x2 drawn from 256 random points, (8, n) Montgomery
    scalar words from 256 random scalars, and (8, n) words of a uniform
    draw below r."""
    rng, npr = random.Random(seed), np.random.default_rng(seed)
    fp, fr = curve.fp, curve.fr
    pool = [curve_ref.random_point(curve, rng) for _ in range(256)]
    idx = torch.from_numpy(npr.integers(256, size=n)).to(device)
    px, py = (mont.words_tensor(mont.ints_to_words(
        fp, [v * mont.radix(fp) % fp.modulus for v in vals]),
        device)[:, idx].contiguous() for vals in zip(*pool))
    s = mont.words_tensor(mont.ints_to_words(
        fr, [rng.randrange(fr.modulus) for _ in range(256)]), device)
    u = npr.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    u[7] %= fr.modulus >> 224
    return px, py, s[:, torch.from_numpy(
        npr.integers(256, size=n)).to(device)].contiguous(), \
        torch.from_numpy(u.astype(np.uint32).view(np.int32)).to(device)


def _scanned(curve, scalars, c: int, px, py, pts):
    """(Streams, *phase A's outputs) of the default build for
    ``scalars``: the arguments of msm.assemble_buckets after the curve."""
    mags, negs = msm.signed_digit_arrays(curve.fr, scalars, c)
    st = msm.sorted_streams(mags, negs, c, msm.default_lanes(
        px.shape[1], mags.shape[0],
        phase_a.resident_threads(curve, px.device)))
    return (st, *phase_a.scan(curve, st.keys, st.sidx, px, py, st.D + 1,
                              pts))


def main(device=None, sizes=(16, 20), kernels=None) -> list:
    """One row a (build, curve, size): the curve's instantiation's
    registers, stack and spills, its blocks an SM, and device ms a call;
    ``kernels`` names the kernels to build (all by default)."""
    if not torch.cuda.is_available():
        raise RuntimeError("occupancy_sweep: no CUDA device")
    device = torch.device(device or "cuda:0")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    builds = [b for b in BUILDS if not kernels or b[0] in kernels]
    with ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda b: _ext._build(*b), builds))
    rows = _point_rows(device, [b for b in builds if b[0] == "point_ops"],
                       sizes) + \
        _ntt_rows(device, [b for b in builds if b[0] == "small_ntt"]) + \
        _dg3_rows(device, [b for b in builds if b[0] == "dg3"])
    builds = [b for b in builds if b[0] in MSM_KERNELS]
    for curve in (BN254, BLS12_377, BLS12_381) if builds else ():
        tag = CURVE_STRUCT[curve.name]
        for log_n in sizes:
            n = 1 << log_n
            px, py, s, su = _inputs(curve, n, device)
            pts = phase_a.point_major(px, py)
            c = msm.window_bits(log_n, bits=curve.fr.bits)
            pool = _scanned(curve, s, c, px, py, pts)
            uniform = _scanned(curve, su, c, px, py, pts)
            st, W = pool[0], pool[0].keys.shape[0]
            tables = msm.assemble_buckets(curve, *pool)
            want = {"phase_a": tables,
                    "buckets": (tables,
                                msm.assemble_buckets(curve, *uniform)),
                    "wscan": reduce.weighted_window_sum(curve, tables)}
            for name, defines in builds:
                extra = {}
                with _ext.variant(name, defines):
                    if name == "phase_a":
                        wave = phase_a.resident_threads(curve, device)
                        st = msm.sorted_streams(
                            *msm.signed_digit_arrays(curve.fr, s, c), c,
                            msm.default_lanes(n, W, wave))
                        call = lambda: phase_a.scan(  # noqa: E731
                            curve, st.keys, st.sidx, px, py, st.D + 1, pts)
                        got = msm.assemble_buckets(curve, st, *call())
                        reps = 3
                    elif name == "buckets":
                        wave = msm.buckets_threads(curve, device)
                        call = lambda: msm.assemble_buckets(  # noqa: E731
                            curve, *pool)
                        got = (call(), msm.assemble_buckets(curve, *uniform))
                        extra["ms_uniform_draw"] = _ms(
                            lambda: msm.assemble_buckets(curve, *uniform), 20)
                        reps = 20
                    else:
                        wave = reduce.wscan_threads(curve, device)
                        call = lambda: reduce.weighted_window_sum(  # noqa
                            curve, tables)
                        got = call()
                        reps = 10
                    ms = _ms(call, reps)
                pairs = zip(got, want[name]) if name == "buckets" else \
                    [(got, want[name])]
                if not all(bool(cp.eq(curve, a, b).all()) for a, b in pairs):
                    raise AssertionError(f"{name} {defines} ({curve.name}, "
                                         f"2^{log_n}): differs from the "
                                         "default build")
                regs = [r[1:] for r in _ext.ptxas_rows(name, defines)
                        if tag in r[0]]
                row = {"kernel": name, "defines": list(defines),
                       "blocks_an_sm": wave / (sms * BLOCK),
                       "curve": curve.name, "log_n": log_n,
                       "default": not defines,
                       "registers_stack_spills": regs, "ms": ms, **extra}
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


def _point_rows(device, builds, sizes) -> list:
    """Each point_ops build on the MSM's bucket-table shape (L, W, D) at
    2^log_n points (``sizes``) for each curve: padd, pmadd, pdbl and pdbl
    with k = c, each build's words equal to the plain version's, device ms
    a launch (torch.profiler, 20 launches) beside the bound (the
    coordinates read and written once, 12, 11, 8 or 8 c products an
    element), the blocks an SM of the build's wave and its ptxas rows."""
    rows = []
    for curve in (BN254, BLS12_377, BLS12_381) if builds else ():
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        L = mont.n_words(curve.fp)
        for log_n in sizes:
            c = msm.window_bits(log_n, bits=curve.fr.bits)
            W = msm.signed_window_count(curve.fr.bits, c)
            N = W << (c - 1)
            px, py, _, _ = _inputs(curve, N, device)
            shape = (L, W, N // W)
            p = cp.dbl_plain(curve, cp.from_affine(curve, cp.AffinePoint(
                px, py)))
            p = cp.ProjPoint(*(a.reshape(shape) for a in p))
            q = cp.ProjPoint(*(a.flip(-1).contiguous() for a in p))
            qa = cp.AffinePoint(*(a.reshape(shape).flip(-1).contiguous()
                                  for a in (px, py)))
            ops = (("padd", point_kernels.padd, cp.add_plain, (p, q), 9, 12),
                   ("pmadd", point_kernels.pmadd, cp.madd_plain, (p, qa), 8,
                    11),
                   ("pdbl", point_kernels.pdbl, point_kernels.pdbl_plain,
                    (p,), 6, 8),
                   ("pdbl_c", lambda cv, x: point_kernels.pdbl(cv, x, c),
                    lambda cv, x: point_kernels.pdbl_plain(cv, x, c), (p,),
                    6, 8 * c))
            for op, kf, pf, args, fes, muls in ops:
                want = pf(curve, *args)
                bnd = bound(fes * 4 * L * N, muls * N * cios_imads(L),
                            IMAD_PER_S)
                kname = op.split("_")[0]
                for name, defines in builds:
                    with _ext.variant(name, defines):
                        call = lambda: kf(curve, *args)  # noqa: E731
                        if not all(torch.equal(a, b) for a, b in
                                   zip(call(), want)):
                            raise AssertionError(
                                f"point_ops {defines} ({curve.name}, {op}, "
                                f"2^{log_n}): differs from the plain version")
                        dev_ms = _device_ms(call, 20, f"{kname}_kernel")
                        wave = point_kernels.point_ops_threads(
                            curve, kname, device)
                    regs = [r[1:] for r in _ext.ptxas_rows(name, defines)
                            if CURVE_STRUCT[curve.name] in r[0]
                            and f"{kname}_kernel" in r[0]]
                    row = {"kernel": name, "defines": list(defines),
                           "curve": curve.name, "log_n": log_n, "op": op,
                           "elements": N, "k": c if op == "pdbl_c" else 1,
                           "default": not defines,
                           "blocks_an_sm": wave / (sms * BLOCK),
                           "registers_stack_spills": regs,
                           "device_ms": dev_ms, **bnd,
                           "share_of_bound": bnd["bound_ms"] / dev_ms}
                    print(json.dumps(row), flush=True)
                    rows.append(row)
    return rows


def _words(n: int, seed: int, top: int, device):
    """(8, n) int32 words of random values whose top word is below
    ``top``."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(8, n),
                                             dtype=np.uint64)
    w[7] %= top
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)


def _ntt_rows(device, builds) -> list:
    """Each small_ntt build at each pass of the radix-2 2^20 and 2^22 NTTs
    (ntt_pallas.pass_shapes) for each scalar field: its words equal to the
    plain version's, device ms a launch (torch.profiler, 20 calls), ms a
    call (CUDA events) and its geometry."""
    rows = []
    for fr in (BN254.fr, BLS12_377.fr, BLS12_381.fr):
        below = (fr.modulus if mont.canon(fr) else 2 * fr.modulus) >> 224
        for log_n, (log_k, nb, batch, with_pre) in (
                (n, shape) for n in (20, 22)
                for shape in ntt_pallas.pass_shapes(n)):
            K = 1 << log_k
            B = nb // (batch or nb)
            x = _words(K * nb, log_k, 1 << 32 if not batch else below,
                       device)
            x = x.reshape(8, B, K, batch) if batch else x.reshape(8, K, nb)
            tw = ntt_pallas.stage_twiddle_rows(fr, log_k,
                                               fr.root_of_unity(log_k),
                                               device)
            pre = _words(K * B, 1, fr.modulus >> 224, device).reshape(
                8, K, B) if with_pre else None
            opts = (pre, None, not batch, log_k == 8)
            want = ntt_pallas.small_ntt_batch_plain(fr, x, log_k, tw, *opts)
            for name, defines in builds:
                with _ext.variant(name, defines):
                    call = lambda: ntt_pallas.small_ntt_batch(  # noqa: E731
                        fr, x, log_k, tw, *opts)
                    if not torch.equal(call(), want):
                        raise AssertionError(f"small_ntt {defines} "
                                             f"({fr.name}, K = {K}): differs "
                                             "from the plain version")
                    ms = _ms(call, 20)
                    dev_ms = _device_ms(call, 20, "small_ntt_kernel")
                    geo = ntt_pallas.small_ntt_geometry(fr, log_k, nb,
                                                        device)
                regs = [r[1:] for r in _ext.ptxas_rows(name, defines)
                        if FIELD_STRUCT[fr.name] in r[0]]
                row = {"kernel": name, "defines": list(defines),
                       "field": fr.name, "log_n": log_n, "log_k": log_k,
                       "batch": batch, "t1": with_pre,
                       "default": not defines, "geometry": geo,
                       "registers_stack_spills": regs, "device_ms": dev_ms,
                       "ms": ms}
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


def _dg3_rows(device, builds) -> list:
    """Each dg3 build at the gather probe's depths (2^22 lookups): its
    words equal to the plain version's, device ms a call (CUDA events, 20
    calls) beside torch.gather's, and its geometry."""
    from . import profile_gather4 as pg
    rows = []
    g = torch.Generator(device=device).manual_seed(4)
    for R in pg.DEPTHS:
        G = (1 << 22) // (R * pg.COLS)
        tab, idx = (torch.randint(0, hi, (G, R, pg.COLS), dtype=torch.int32,
                                  generator=g, device=device)
                    for hi in (1 << 31, R))
        want = pg.dg3_plain(tab, idx)
        idx64 = idx.long()
        gather = lambda: torch.gather(tab, 1, idx64)  # noqa: E731
        gather_ms = _device_ms(gather, 20, "")
        for name, defines in builds:
            with _ext.variant(name, defines):
                if not torch.equal(pg.dg3(tab, idx), want):
                    raise AssertionError(f"dg3 {defines} (R = {R}): differs "
                                         "from the plain version")
                ms = _ms(lambda: pg.dg3(tab, idx), 20)
                dev_ms = _device_ms(lambda: pg.dg3(tab, idx), 20,
                                    "dg3_kernel")
                geo = pg.dg3_geometry(G, R, device)
            row = {"kernel": name, "defines": list(defines), "R": R,
                   "default": not defines, "geometry": geo,
                   "registers_stack_spills": [
                       r[1:] for r in _ext.ptxas_rows(name, defines)],
                   "device_ms": dev_ms, "ms": ms,
                   "gather_device_ms": gather_ms}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    print(f"[occupancy_sweep] {torch.cuda.get_device_name(0)}" if
          torch.cuda.is_available() else "", flush=True)
    main(kernels=sys.argv[1:] or None)
