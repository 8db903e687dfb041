"""Pippenger multi-scalar multiplication on torch tensors.

Counterpart of ``panda_tpu/ops/msm.py`` with the same decomposition:

1. scalars out of Montgomery form and into W signed c-bit windows
   (``ops/digits``, kernel ``csrc/digits.cu``);
2. every window's digits sorted at once (``torch.sort``, stable);
3. phase A sweeps the sorted streams, one (window, lane) per thread,
   accumulating runs of equal digits with complete mixed adds and emitting
   each finished run (``ops/phase_a``, kernel ``csrc/phase_a.cu``);
4. bucket b's run ends at hi_b = #(digit <= b) (histogram kernel
   ``csrc/hist.cu`` plus a cumsum, or ``searchsorted`` below D = 512), so
   the dense bucket table is a gather of the emission stream, plus a
   segmented scan over the lanes' tails and one complete add
   (``csrc/point_ops.cu``);
5. the weighted reduction sum_d d B_d per window (``csrc/wscan.cu``);
6. Horner across windows on the host, in big integers.

Point-chunking beyond 2^20 points (the JAX package's
``_window_sums_chunked``, tuned to a TPU gather cliff) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..curves import point as cp
from ..curves.config import CurveSpec
from ..curves.point import ProjPoint
from ..fields import mont
from ..fields.config import FieldSpec
from ..reference import curve_ref
from . import digits as digits_ops
from . import hist as hist_ops
from . import phase_a
from . import reduce as red

# Largest n the port runs; beyond it the JAX package chunks the points.
MAX_N = 1 << 20

# Phase A's geometry on the H100.  One launch runs W_g * m threads, each a
# chain of S = n / m mixed adds that depend on each other, so the card is
# filled by threads in flight.  For BN254, csrc/phase_a.cu caps a thread at
# 128 registers (launch bounds 128 x 4), which keeps 16 warps resident on
# each of the 132 SMs, 67,584 threads in all.  Every launch gets the least
# lane count with at least _PHASE_A_THREADS = 2^16 threads (the JAX
# package's 2^14 was sized on a v5e to fill its limb kernels: 4 warps an SM
# here), which still fits that one wave: 20 x 3277 (20 steps) at 2^16,
# 16 x 4096 (256 steps) at 2^20.  The BLS curves' 12-word lanes take up to
# 255 registers (launch bounds 128 x 2), 33,792 resident threads, so the
# same 2^16 threads run in two waves.
_PHASE_A_THREADS = 1 << 16

# Upper bound on W_g * n entries staged by one phase-A launch: 2^24, so all
# windows of a 2^20 MSM run in one launch.  An entry costs ~108 bytes with
# 8-word coordinates (key and index 8, emission key and sum 4 + 96) and
# ~156 with 12 (8, 4 + 144): ~1.8 GB for BN254 and ~2.6 GB for the BLS
# curves at 2^24 entries, of the card's 80 GB (the JAX package's 2^22 was
# sized for 16 GB of HBM).
_PHASE_A_BUDGET = 1 << 24

# Below this bucket count, per-target binary search replaces the histogram.
_HIST_MIN_D = 512


def default_lanes(n: int, windows: int = 1) -> int:
    """Per-window phase-A lane count: the least m with
    windows * m >= _PHASE_A_THREADS, at most n."""
    return max(min(-(-_PHASE_A_THREADS // max(windows, 1)), n), 1)


def _cost_model_lanes(n: int, windows: int) -> int:
    """The JAX package's lane rule, which window_bits' cost model keeps:
    with default_lanes in its place the model would move c at 2^9..2^12
    and 2^15 (re-deriving the model for the H100 is a ROADMAP item)."""
    target = max(16384 // max(windows, 1), 128)
    return max(min(1 << (target.bit_length() - 1), n), 1)


def signed_window_count(bits: int, c: int) -> int:
    """Windows needed for signed-digit recoding: the top window keeps a
    headroom bit so the incoming carry cannot overflow."""
    w = -(-bits // c)
    if w * c < bits + 1:
        w += 1
    return w


def window_bits(log_n: int, bits: int = 254) -> int:
    """Window width c from the JAX package's point-op cost model (phase-A
    mixed adds + bucket reduction + tail collapse per window), capped at 16.
    """
    def best_for(log_n: int) -> int:
        n = 1 << log_n
        best_c, best_cost = 4, None
        for c in range(4, 17):
            windows = signed_window_count(bits, c)
            m = _cost_model_lanes(n, windows)
            per_window = n + 3 * (1 << (c - 1)) + m * (m.bit_length() + 2)
            cost = windows * per_window
            if best_cost is None or cost < best_cost:
                best_c, best_cost = c, cost
        return best_c

    return max(best_for(k) for k in range(2, log_n + 1)) if log_n > 2 \
        else best_for(log_n)


def signed_digit_arrays(fr: FieldSpec, scalars: torch.Tensor, c: int):
    """(mags, negs) signed-digit recode of (8, n) Montgomery scalar words
    into signed_window_count(fr.bits, c) windows."""
    return digits_ops.signed_digits(fr, scalars, c,
                                    signed_window_count(fr.bits, c))


def _cum_counts(digits: torch.Tensor, D: int, n_real: int) -> torch.Tensor:
    """hi_b = #(digit <= b) per window for b = 1..D; ``n_real`` counts the
    entries that are not dead keys."""
    hist = hist_ops.hist_counts(digits, D).to(torch.int64)
    count0 = n_real - hist.sum(dim=1, keepdim=True)
    return count0 + torch.cumsum(hist, dim=1)


def _locate_runs(keys_sorted, digits, D: int, n_real: int) -> torch.Tensor:
    """Run-end positions hi_b (b = 1..D) in the sorted digit stream."""
    if D < _HIST_MIN_D:
        targets = torch.arange(1, D + 1, dtype=keys_sorted.dtype,
                               device=keys_sorted.device)
        return torch.searchsorted(
            keys_sorted.contiguous(),
            targets.expand(keys_sorted.shape[0], D).contiguous(), right=True)
    return _cum_counts(digits, D, n_real)


class Streams(NamedTuple):
    """Phase A's input: the sorted digit streams of W windows in step-major
    (W, S, m) layout, and the run ends hi_b (W, D)."""
    keys: torch.Tensor
    sidx: torch.Tensor
    hi: torch.Tensor
    n: int
    D: int


def sorted_streams(digits, signs, c: int, m: int) -> Streams:
    """Sort every window's digits at once; the point index and, in bit 31,
    the digit's sign ride along; pad to S * m entries with the dead key."""
    W, n = digits.shape
    D = 1 << (c - 1)
    steps = -(-n // m)
    P = m * steps
    keys, perm = torch.sort(digits, dim=1, stable=True)
    perm = perm.to(torch.int32)
    sidx = torch.where(signs.gather(1, perm.long()), perm | -(1 << 31), perm)
    if P > n:
        keys = torch.cat([keys, keys.new_full((W, P - n), D + 1)], dim=1)
        sidx = torch.cat([sidx, sidx.new_zeros((W, P - n))], dim=1)
    hi = _locate_runs(keys, digits, D, n)

    def step_major(a):       # (W, P) lane-major -> (W, S, m)
        return a.view(W, m, steps).transpose(1, 2).contiguous()

    return Streams(step_major(keys), step_major(sidx), hi, n, D)


def assemble_buckets(curve: CurveSpec, st: Streams, ekeys, epts, tkeys,
                     tpts) -> ProjPoint:
    """Dense bucket tables (L, W, D) from phase A's emissions and tails."""
    W, steps, m = st.keys.shape
    P, D, L = steps * m, st.D, epts.x.shape[0]
    dev = ekeys.device
    targets = torch.arange(1, D + 1, dtype=torch.int32, device=dev)
    ident = cp.identity(curve, (W, D), dev)

    # Bucket b's run ends just before sorted position hi_b; the lane that
    # reads hi_b emits it there, unless hi_b starts a new lane (then the run
    # reaches the lane's tail instead).
    slot = st.hi.clamp(0, P - 1)
    pos = (slot % steps) * m + slot // steps                 # step-major
    k_at = ekeys.reshape(W, P).gather(1, pos)
    valid_i = (k_at == targets) & (st.hi % steps != 0)
    gpos = pos.unsqueeze(0).expand(L, W, D)
    ipts = ProjPoint(*(a.reshape(L, W, P).gather(2, gpos) for a in epts))
    interior = cp.select(valid_i, ipts, ident)

    # Tails: merge the tails of lanes a bucket spans with one segmented
    # scan; the run's last lane holds the total.  Lanes whose last entry is
    # padding carry the dead key: n // steps lanes are live.
    tstarts = torch.cat([torch.ones((W, 1), dtype=torch.bool, device=dev),
                         tkeys[:, 1:] != tkeys[:, :-1]], dim=1)
    tsum = red.segmented_prefix_scan(curve, tpts, tstarts)
    tpos = _locate_runs(tkeys, tkeys, D, st.n // steps) - 1  # may be -1
    tslot = tpos.clamp(0, m - 1)
    valid_t = (tkeys.gather(1, tslot) == targets) & (tpos >= 0)
    gts = tslot.unsqueeze(0).expand(L, W, D)
    tpick = ProjPoint(*(a.gather(2, gts) for a in tsum))
    tails = cp.select(valid_t, tpick, ident)
    return cp.add(curve, interior, tails)


def _bucket_tables(curve: CurveSpec, px, py, digits, signs, c: int,
                   m: int) -> ProjPoint:
    """Dense bucket tables B_1..B_D of every window: (L, W, D) coordinates,
    D = 2^(c-1); negative digits enter as the negated point."""
    st = sorted_streams(digits, signs, c, m)
    return assemble_buckets(
        curve, st, *phase_a.scan(curve, st.keys, st.sidx, px, py, st.D + 1))


def _window_group_size(n: int, W: int) -> int:
    return min(max(_PHASE_A_BUDGET // max(n, 1), 1), W)


def window_sums(curve: CurveSpec, px, py, digits, signs,
                c: int) -> ProjPoint:
    """Per-window sums G_w as (L, W) coordinates.  Windows run in groups
    of at most _PHASE_A_BUDGET / n, which bounds the staged memory: one
    group up to 2^20 points."""
    W, n = digits.shape
    if n > MAX_N:
        raise NotImplementedError(
            f"MSM of {n} > 2^20 points: the point-chunked path is not ported "
            "yet (ROADMAP: the chunked MSM path above 2^20)")
    wg = _window_group_size(n, W)
    m = default_lanes(n, wg)
    parts = []
    for g in range(0, W, wg):
        d, s = digits[g:g + wg], signs[g:g + wg]
        if d.shape[0] < wg:                     # pad: digit 0 -> identity
            extra = wg - d.shape[0]
            d = torch.cat([d, d.new_zeros((extra, n))])
            s = torch.cat([s, s.new_zeros((extra, n))])
        buckets = _bucket_tables(curve, px, py, d, s, c, m)
        parts.append(red.weighted_window_sum(curve, buckets))
    return ProjPoint(*(torch.cat([p[i] for p in parts], dim=1)[:, :W]
                       for i in range(3)))


def window_sums_fn(curve: CurveSpec, c: int):
    """(px, py, scalars) -> window sums (L, W) x3: the device part of the
    byte-API MSM; the Horner tail runs on the host."""
    def fn(px, py, scalars):
        mags, negs = signed_digit_arrays(curve.fr, scalars, c)
        return window_sums(curve, px, py, mags, negs, c)
    return fn


def host_horner(curve: CurveSpec, sums: ProjPoint, c: int):
    """Horner over the window sums in host big integers; returns the affine
    result (x, y) as plain ints, or None for the identity."""
    p = curve.fp.modulus
    rinv = pow(mont.radix(curve.fp), -1, p)
    xs, ys, zs = (mont.words_to_ints(a) for a in sums)
    acc = None
    for w in reversed(range(len(xs))):
        for _ in range(c):
            acc = curve_ref.ec_add(curve, acc, acc)
        z = zs[w] * rinv % p
        if z == 0:
            continue
        zi = pow(z, -1, p)
        gx = xs[w] * rinv % p * zi % p
        gy = ys[w] * rinv % p * zi % p
        acc = curve_ref.ec_add(curve, acc, (gx, gy))
    return acc
