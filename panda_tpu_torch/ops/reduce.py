"""Point-reduction primitives for the MSM bucket tables, and
:func:`total_sum` of a batch of points.

Counterpart of ``panda_tpu/ops/reduce.py``.  PyTorch runs eagerly, so the
JAX package's one-add-instance ``fori_loop``/``scan`` bodies become plain
Python loops of plain point adds: the plain versions.  The weighted
reduction :func:`weighted_window_sum` runs on the device as two launches
of ``csrc/wscan.cu`` (segment scans and a block combine in shared memory,
then the blocks' partial sums); its plain version, beside it, is the JAX
package's blocked decomposition.  The segmented scan serves the plain
bucket assembly (``ops/msm.assemble_buckets_plain``), whose device form is
``csrc/buckets.cu``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..curves import point as cp
from ..curves.config import CurveSpec
from ..curves.point import ProjPoint
from . import _ext
from ._ext import I32, I64, P


def _ceil_log2(n: int) -> int:
    return max((n - 1).bit_length(), 0)


def _roll(pts: ProjPoint, shift: int) -> ProjPoint:
    return ProjPoint(*(torch.roll(a, shift, dims=-1) for a in pts))


def _last(pts: ProjPoint, sl) -> ProjPoint:
    return ProjPoint(*(a[..., sl] for a in pts))


def segmented_prefix_scan(curve: CurveSpec, pts: ProjPoint,
                          seg_start: torch.Tensor) -> ProjPoint:
    """Inclusive segmented prefix sums along the last axis (Hillis-Steele,
    plain adds): the plain bucket assembly's tail scan.  ``seg_start`` is
    True where a segment begins."""
    n = pts.x.shape[-1]
    idx = torch.arange(n, device=pts.x.device)
    f = seg_start.to(torch.bool)
    for i in range(_ceil_log2(n)):
        s = 1 << i
        in_range = idx >= s
        added = cp.add_plain(curve, pts, _roll(pts, s))
        pts = cp.select(in_range & ~f, added, pts)
        f = torch.where(in_range, f | torch.roll(f, s, dims=-1), f)
    return pts


# ---------------------------------------------------------------------------
# Weighted reduction: the plain version
# ---------------------------------------------------------------------------

def suffix_scan(curve: CurveSpec, pts: ProjPoint) -> ProjPoint:
    """Inclusive suffix sums along the last axis: out[i] = sum_{j>=i} pts[j]
    (plain adds)."""
    n = pts.x.shape[-1]
    idx = torch.arange(n, device=pts.x.device)
    for i in range(_ceil_log2(n)):
        s = 1 << i
        added = cp.add_plain(curve, pts, _roll(pts, -s))
        pts = cp.select(idx < n - s, added, pts)
    return pts


def small_total(curve: CurveSpec, pts: ProjPoint) -> ProjPoint:
    """Sum along the last axis through the log-depth suffix scan."""
    return _last(suffix_scan(curve, pts), 0)


def dbl_pow2(curve: CurveSpec, pt: ProjPoint, log_k: int) -> ProjPoint:
    """pt * 2^log_k (plain doublings)."""
    for _ in range(log_k):
        pt = cp.dbl_plain(curve, pt)
    return pt


def total_sum(curve: CurveSpec, pts: ProjPoint) -> ProjPoint:
    """Sum all points along the last axis to one point: the log-depth fold
    ``curves.point.fold_sum``, one complete add a level (a padd launch on
    the card).  The JAX package scans n / lanes adds and folds the lanes,
    to keep XLA's program small; eagerly the fold's ceil(log2 n) levels
    are the fewest launches, and the sum is the same point."""
    return cp.fold_sum(curve, pts)


def lane_split(batch: int, d: int) -> tuple:
    """(lanes, steps) of the plain weighted reduction of ``batch`` tables of
    d buckets: the JAX package's cost model without its TPU tile constraint."""
    target = max(8192 // max(batch, 1), 1)
    log_lanes = min(max(target.bit_length() - 1, 0), _ceil_log2(d) // 2 + 3,
                    _ceil_log2(d))
    return 1 << log_lanes, 1 << (_ceil_log2(d) - log_lanes)


def weighted_scan_plain(curve: CurveSpec, b: ProjPoint):
    """``b`` coordinates (L, S, N); reverse loop over S with run += B_s,
    wsum += run.  Returns (run, wsum) triples of (L, N): run = sum_s B_s,
    wsum = sum_s (s + 1) B_s."""
    S, N = b.x.shape[1:]
    run = cp.identity(curve, (N,), b.x.device)
    wsum = cp.identity(curve, (N,), b.x.device)
    for s in range(S - 1, -1, -1):
        run = cp.add_plain(curve, run, ProjPoint(*(a[:, s] for a in b)))
        wsum = cp.add_plain(curve, wsum, run)
    return run, wsum


def weighted_window_sum_plain(curve: CurveSpec,
                              buckets: ProjPoint) -> ProjPoint:
    """Plain version of :func:`weighted_window_sum`, the JAX package's
    blocked decomposition d = q S + (r + 1), lane q, step r:

        sum_d d B_d = sum_q [ sum_r (r+1) B_{q,r} ]  +  S * sum_q q T_q

    with T_q the per-lane plain sums: a weighted scan over the steps, then
    log-depth suffix scans over the lanes and doublings."""
    d = buckets.x.shape[-1]
    lead = tuple(buckets.x.shape[1:-1])
    if d == 1:
        return _last(buckets, 0)
    batch = math.prod(lead)
    lanes, steps = lane_split(batch, d)
    log_steps = steps.bit_length() - 1
    pad = lanes * steps - d
    dev = buckets.x.device
    if pad:
        ident = cp.identity(curve, lead + (pad,), dev)
        buckets = ProjPoint(*(torch.cat([a, b], dim=-1)
                              for a, b in zip(buckets, ident)))
    L = buckets.x.shape[0]
    # (L, *lead, lanes*steps) -> (L, steps, batch*lanes): step-major columns
    cols = ProjPoint(*(a.reshape(L, batch, lanes, steps).permute(0, 3, 1, 2)
                       .reshape(L, steps, batch * lanes) for a in buckets))
    run, wsum = weighted_scan_plain(curve, cols)
    t = ProjPoint(*(a.reshape((L,) + lead + (lanes,)) for a in run))
    wsum = ProjPoint(*(a.reshape((L,) + lead + (lanes,)) for a in wsum))
    total_w = small_total(curve, wsum)
    if lanes == 1:
        return total_w
    cross = small_total(curve, _last(suffix_scan(curve, t), slice(1, None)))
    return cp.add_plain(curve, total_w, dbl_pow2(curve, cross, log_steps))


# ---------------------------------------------------------------------------
# Weighted reduction on the device
# ---------------------------------------------------------------------------

# csrc/wscan.cu's geometry: blocks of at most _WSCAN_BLOCK threads (its
# kThreads); level 0 aims at _WSCAN_THREADS threads.  The threads resident
# at once come from the kernel's build (ptt_wscan_threads: on the H100,
# 132 SMs x 2 blocks of 128).
_WSCAN_BLOCK = 128
_WSCAN_THREADS = 1 << 16


class Level(NamedTuple):
    """One launch of csrc/wscan.cu: E elements a window in segments of
    ``seg``, ``threads`` segments a block, ``blocks`` blocks a window."""
    E: int
    seg: int
    threads: int
    blocks: int


def _level(E: int, seg: int) -> Level:
    segs = -(-E // seg)
    T = min(_WSCAN_BLOCK, 1 << _ceil_log2(segs))
    return Level(E, seg, T, -(-segs // T))


def wscan_plan(windows: int, d: int, wave: int) -> list:
    """The launches of :func:`weighted_window_sum` for ``windows`` tables of
    d buckets on a card that holds ``wave`` threads at once.  Level 0 takes
    segments of 2^k >= 2 buckets, a thread each: the longest that still
    give _WSCAN_THREADS threads (2^20 MSM: 16 x 32768 buckets in segments
    of 8, 65,536 threads in two waves, 32 blocks a window), or, where the
    tables are too small for that, the shortest that fit one wave (2^16:
    20 x 4096 buckets in segments of 4).  Level 1 takes segments long
    enough for one block a window, so it is the last."""
    full = (windows * d // _WSCAN_THREADS).bit_length() - 1
    seg = 1 << (full if full >= 1 else
                max(1, _ceil_log2(-(-windows * d // wave))))
    levels = [_level(d, seg)]
    while levels[-1].blocks > 1:
        E = levels[-1].blocks
        levels.append(_level(E, 1 << _ceil_log2(-(-E // _WSCAN_BLOCK))))
    return levels


def wscan_threads(curve: CurveSpec, device: torch.device) -> int:
    """Threads of one full wave of csrc/wscan.cu for ``curve`` on the card
    ``device``, in blocks of _WSCAN_BLOCK, as the kernel's build allows."""
    return _ext.resident_threads(
        "wscan", "ptt_wscan_threads",
        _ext.kernel_field("weighted_window_sum", curve, _ext.MSM_CURVES),
        device)


def wscan_level(curve: CurveSpec, lv: Level, x: ProjPoint, p):
    """One launch of csrc/wscan.cu: level ``lv`` over x (L, W, lv.E) and
    the plain terms p (None at level 0); returns the next level's (p, x),
    x None after the last level, whose p is the window sums (L, W, 1)."""
    L, W = x.x.shape[:2]
    cid = _ext.kernel_field("weighted_window_sum", curve, _ext.MSM_CURVES)
    out = [torch.empty((L, W, lv.blocks), dtype=torch.int32,
                       device=x.x.device)
           for _ in range(6 if lv.blocks > 1 else 3)]
    ptrs = [a.data_ptr() for a in x]
    ptrs += [a.data_ptr() for a in p] if p else [None] * 3
    ptrs += [a.data_ptr() for a in out] + [None] * (6 - len(out))
    _ext.launch("wscan", "ptt_wscan_level", [P] * 12 + [I64] * 3 + [I32] * 4,
                ptrs + [W, lv.E, lv.blocks, lv.seg, lv.threads,
                        int(p is None), cid], x.x.device)
    return (ProjPoint(*out[:3]),
            ProjPoint(*out[3:]) if lv.blocks > 1 else None)


def weighted_window_sum(curve: CurveSpec, buckets: ProjPoint) -> ProjPoint:
    """sum_{d>=1} d * B_d for buckets B_1..B_D along the last axis of
    (L, *batch, D) coordinates; returns (L, *batch).  CPU tensors take
    :func:`weighted_window_sum_plain`; CUDA tensors the launches of
    :func:`wscan_plan` for the threads the kernel's build holds at once."""
    if _ext.on_cpu("weighted_window_sum", buckets.x):
        return weighted_window_sum_plain(curve, buckets)
    L, *lead, D = buckets.x.shape
    W = math.prod(lead)
    x = ProjPoint(*(a.reshape(L, W, D).contiguous() for a in buckets))
    _ext.check_cuda("weighted_window_sum", *x)
    _ext.check_words("weighted_window_sum", curve.fp, x.x)
    p = None
    for lv in wscan_plan(W, D, wscan_threads(curve, x.x.device)):
        p, x = wscan_level(curve, lv, x, p)
    return ProjPoint(*(a.reshape([L] + lead) for a in p))
