"""Point-reduction primitives for the MSM bucket tables.

Counterpart of ``panda_tpu/ops/reduce.py``.  PyTorch runs eagerly, so the
JAX package's one-add-instance ``fori_loop``/``scan`` bodies become plain
Python loops; each step is one batched point op (one kernel launch on the
GPU).  The inner loop of :func:`weighted_window_sum` is the weighted-scan
kernel (``ops/point_kernels.weighted_scan``, ``csrc/wscan.cu``).
"""

from __future__ import annotations

import math

import torch

from ..curves import point as cp
from ..curves.config import CurveSpec
from ..curves.point import ProjPoint
from . import point_kernels


def _ceil_log2(n: int) -> int:
    return max((n - 1).bit_length(), 0)


def _roll(pts: ProjPoint, shift: int) -> ProjPoint:
    return ProjPoint(*(torch.roll(a, shift, dims=-1) for a in pts))


def _last(pts: ProjPoint, sl) -> ProjPoint:
    return ProjPoint(*(a[..., sl] for a in pts))


def segmented_prefix_scan(curve: CurveSpec, pts: ProjPoint,
                          seg_start: torch.Tensor) -> ProjPoint:
    """Inclusive segmented prefix sums along the last axis (Hillis-Steele).
    ``seg_start`` is True where a segment begins."""
    n = pts.x.shape[-1]
    idx = torch.arange(n, device=pts.x.device)
    f = seg_start.to(torch.bool)
    for i in range(_ceil_log2(n)):
        s = 1 << i
        in_range = idx >= s
        added = cp.add(curve, pts, _roll(pts, s))
        pts = cp.select(in_range & ~f, added, pts)
        f = torch.where(in_range, f | torch.roll(f, s, dims=-1), f)
    return pts


def suffix_scan(curve: CurveSpec, pts: ProjPoint) -> ProjPoint:
    """Inclusive suffix sums along the last axis: out[i] = sum_{j>=i} pts[j]."""
    n = pts.x.shape[-1]
    idx = torch.arange(n, device=pts.x.device)
    for i in range(_ceil_log2(n)):
        s = 1 << i
        added = cp.add(curve, pts, _roll(pts, -s))
        pts = cp.select(idx < n - s, added, pts)
    return pts


def small_total(curve: CurveSpec, pts: ProjPoint) -> ProjPoint:
    """Sum along the last axis through the log-depth suffix scan."""
    return _last(suffix_scan(curve, pts), 0)


def dbl_pow2(curve: CurveSpec, pt: ProjPoint, log_k: int) -> ProjPoint:
    """pt * 2^log_k."""
    for _ in range(log_k):
        pt = cp.dbl(curve, pt)
    return pt


def lane_split(batch: int, d: int) -> tuple:
    """(lanes, steps) of the weighted reduction of ``batch`` tables of d
    buckets: the JAX package's cost model without its TPU tile constraint."""
    target = max(8192 // max(batch, 1), 1)
    log_lanes = min(max(target.bit_length() - 1, 0), _ceil_log2(d) // 2 + 3,
                    _ceil_log2(d))
    return 1 << log_lanes, 1 << (_ceil_log2(d) - log_lanes)


def weighted_window_sum(curve: CurveSpec, buckets: ProjPoint) -> ProjPoint:
    """sum_{d>=1} d * B_d for buckets B_1..B_D along the last axis of
    (L, *batch, D) coordinates; returns (L, *batch).

    Blocked decomposition d = q S + (r + 1), lane q, step r:

        sum_d d B_d = sum_q [ sum_r (r+1) B_{q,r} ]  +  S * sum_q q T_q

    with T_q the per-lane plain sums.  The weighted-scan kernel computes
    both inner terms in one pass; the lane combine uses the suffix scan."""
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
    run, wsum = point_kernels.weighted_scan(curve, cols)
    t = ProjPoint(*(a.reshape((L,) + lead + (lanes,)) for a in run))
    wsum = ProjPoint(*(a.reshape((L,) + lead + (lanes,)) for a in wsum))
    total_w = small_total(curve, wsum)
    if lanes == 1:
        return total_w
    cross = small_total(curve, _last(suffix_scan(curve, t), slice(1, None)))
    return cp.add(curve, total_w, dbl_pow2(curve, cross, log_steps))
