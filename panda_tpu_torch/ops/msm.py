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
   the dense bucket table is the emission at hi_b plus the total of the
   lanes' tails with key b: two launches of ``csrc/buckets.cu`` (a
   segmented reduction of the tails, then a thread a bucket);
5. the weighted reduction sum_d d B_d per window (``csrc/wscan.cu``);
6. Horner across windows on the host, in big integers (the byte API), or
   on the device with the point kernels (:func:`horner`, :func:`msm`: a
   window's c doublings in one ``pdbl`` launch, then one ``padd``).

Above ``chunk_n`` points (:data:`CHUNK_N`, 2^20 unless
``PANDA_MSM_CHUNK_LOG`` says otherwise) the points run in chunks, as the
JAX package's ``_window_sums_chunked``: each chunk takes steps 2-4 to its
dense bucket tables, successive chunks' tables are summed with one complete
add (``curves.point.add``, the ``point_ops`` padd kernel on the card), and
one weighted reduction runs at the end.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..curves import point as cp
from ..curves.config import CurveSpec
from ..curves.point import ProjPoint
from ..fields import mont
from ..fields.config import FieldSpec
from ..reference import curve_ref
from . import _ext
from ._ext import I32, I64, P
from . import digits as digits_ops
from . import hist as hist_ops
from . import phase_a, point_kernels
from . import reduce as red

# Points a chunk: above it window_sums runs the points in chunks of this
# size, as the JAX package does (its _CHUNK_N, the same variable).
CHUNK_N = 1 << int(os.environ.get("PANDA_MSM_CHUNK_LOG", "20"))

# Phase A's geometry.  One launch runs W_g * m threads, each a chain of
# S = n / m mixed adds that depend on each other, so the card is filled by
# threads in flight: every launch gets the most lanes that still run in one
# wave of the kernel's resident threads (phase_a.resident_threads), at most
# n.  On the H100 (132 SMs; 4 blocks of 128 an SM for BN254, 3 for the BLS
# curves) BN254 runs 67,584 threads, 20 x 3379 (20 steps) at 2^16 and
# 16 x 4224 (249 steps) at 2^20; the BLS curves 50,688, 20 x 2534 (26
# steps) and 16 x 3168 (331 steps).

# Upper bound on W_g * n entries staged by one phase-A launch: 2^24, so all
# windows of a 2^20 MSM run in one launch.  An entry costs ~108 bytes with
# 8-word coordinates (key and index 8, emission key and sum 4 + 96) and
# ~156 with 12 (8, 4 + 144): ~1.8 GB for BN254 and ~2.6 GB for the BLS
# curves at 2^24 entries, of the card's 80 GB (the JAX package's 2^22 was
# sized for 16 GB of HBM).
_PHASE_A_BUDGET = 1 << 24

# Below this bucket count, per-target binary search replaces the histogram.
_HIST_MIN_D = 512


def default_lanes(n: int, windows: int, threads: int) -> int:
    """Per-window phase-A lane count: the most m with windows * m <=
    ``threads`` (one wave), at most n."""
    return max(min(threads // max(windows, 1), n), 1)


def _cost_model_lanes(n: int, windows: int) -> int:
    """The JAX package's lane rule, which window_bits' cost model keeps:
    with the H100's lane rule in its place the model would move c
    (re-deriving the model for the H100 is a ROADMAP item)."""
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


def assemble_buckets_plain(curve: CurveSpec, st: Streams, ekeys, epts,
                           tkeys, tpts) -> ProjPoint:
    """Plain version of :func:`assemble_buckets`: gathers, a segmented scan
    over the lanes' tails and one complete add over the tables."""
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
    # padding carry the dead key D + 1; the tail keys are sorted, so the
    # run of b ends before #(tail key <= b).
    tstarts = torch.cat([torch.ones((W, 1), dtype=torch.bool, device=dev),
                         tkeys[:, 1:] != tkeys[:, :-1]], dim=1)
    tsum = red.segmented_prefix_scan(curve, tpts, tstarts)
    tpos = torch.searchsorted(tkeys.contiguous(),
                              targets.expand(W, D).contiguous(),
                              right=True) - 1                # may be -1
    tslot = tpos.clamp(0, m - 1)
    valid_t = (tkeys.gather(1, tslot) == targets) & (tpos >= 0)
    gts = tslot.unsqueeze(0).expand(L, W, D)
    tpick = ProjPoint(*(a.gather(2, gts) for a in tsum))
    tails = cp.select(valid_t, tpick, ident)
    return cp.add_plain(curve, interior, tails)


# csrc/buckets.cu's tails launch: blocks of at most _BUCKETS_BLOCK threads
# (its kThreads), each thread a chunk of consecutive lanes, the fewest that
# let one wave of the card hold the launch: each lane of a chunk may cost
# its thread a dependent add (a block whose runs outgrow it takes longer
# chunks).
_BUCKETS_BLOCK = 128


class BucketPlan(NamedTuple):
    """The tails launch: ``blocks`` blocks a window of ``threads`` threads,
    ``chunk`` consecutive lanes a thread (block g from the first run that
    starts at or after lane g x threads x chunk)."""
    chunk: int
    threads: int
    blocks: int


def bucket_plan(windows: int, m: int, wave: int) -> BucketPlan:
    """The tails launch for ``windows`` windows of m lanes on a card that
    holds ``wave`` threads of it at once."""
    chunk = 1
    while chunk < m and windows * -(-m // (_BUCKETS_BLOCK * chunk)) * \
            _BUCKETS_BLOCK > wave:
        chunk += 1
    T = min(_BUCKETS_BLOCK, 1 << max((-(-m // chunk) - 1).bit_length(), 0))
    return BucketPlan(chunk, T, -(-m // (T * chunk)))


def buckets_threads(curve: CurveSpec, device: torch.device) -> int:
    """Threads of one full wave of csrc/buckets.cu's tails launch for
    ``curve`` on the card ``device``, as the kernel's build allows."""
    return _ext.resident_threads(
        "buckets", "ptt_buckets_threads",
        _ext.kernel_field("assemble_buckets", curve, _ext.MSM_CURVES),
        device)


def bucket_launch(curve: CurveSpec, plan: BucketPlan, st: Streams, ekeys,
                  epts, tkeys, tpts, out, fill: bool) -> None:
    """One launch of csrc/buckets.cu into the (L, W, D) tables ``out``: the
    buckets with tails (``fill`` False: plan's tails launch) or the others
    (``fill`` True: their interior emission or the identity)."""
    W, steps, m = st.keys.shape
    cid = _ext.kernel_field("assemble_buckets", curve, _ext.MSM_CURVES)
    _ext.launch("buckets", "ptt_buckets", [P] * 12 + [I64] * 4 + [I32] * 5,
                [*(a.data_ptr() for a in epts), ekeys.data_ptr(),
                 *(a.data_ptr() for a in tpts), tkeys.data_ptr(),
                 st.hi.data_ptr(), *(a.data_ptr() for a in out), W, steps,
                 m, plan.blocks, st.D, plan.chunk, plan.threads, int(fill),
                 cid], ekeys.device)


def assemble_buckets(curve: CurveSpec, st: Streams, ekeys, epts, tkeys,
                     tpts) -> ProjPoint:
    """Dense bucket tables (L, W, D) from phase A's emissions and tails.
    CPU tensors take :func:`assemble_buckets_plain`; CUDA tensors the two
    launches of csrc/buckets.cu (the buckets with tails, then the others),
    planned by :func:`bucket_plan` for the threads the kernel's build holds
    at once.  The kernel's projective representatives differ from the
    plain version's: compare with ``cp.eq``."""
    if _ext.on_cpu("assemble_buckets", ekeys):
        return assemble_buckets_plain(curve, st, ekeys, epts, tkeys, tpts)
    W, steps, m = st.keys.shape
    epts = ProjPoint(*(a.contiguous() for a in epts))
    tpts = ProjPoint(*(a.contiguous() for a in tpts))
    ekeys, tkeys = ekeys.contiguous(), tkeys.contiguous()
    _ext.check_cuda("assemble_buckets", ekeys, tkeys, *epts, *tpts)
    _ext.check_words("assemble_buckets", curve.fp, epts.x)
    L = epts.x.shape[0]
    if ekeys.shape != (W, steps, m) or tkeys.shape != (W, m) or \
            epts.x.shape != (L, W, steps, m) or tpts.x.shape != (L, W, m):
        raise ValueError("assemble_buckets: shape mismatch")
    if st.hi.dtype != torch.int64 or st.hi.shape != (W, st.D) or \
            st.hi.device != ekeys.device or not st.hi.is_contiguous():
        raise ValueError("assemble_buckets: hi must be contiguous (W, D) "
                         "int64 on the tensors' device")
    plan = bucket_plan(W, m, buckets_threads(curve, ekeys.device))
    out = ProjPoint(*(torch.empty((L, W, st.D), dtype=torch.int32,
                                  device=ekeys.device) for _ in range(3)))
    for fill in (False, True):
        bucket_launch(curve, plan, st, ekeys, epts, tkeys, tpts, out, fill)
    return out


def _bucket_tables(curve: CurveSpec, px, py, digits, signs, c: int,
                   m: int, pts=None) -> ProjPoint:
    """Dense bucket tables B_1..B_D of every window: (L, W, D) coordinates,
    D = 2^(c-1); negative digits enter as the negated point."""
    st = sorted_streams(digits, signs, c, m)
    return assemble_buckets(curve, st, *phase_a.scan(
        curve, st.keys, st.sidx, px, py, st.D + 1, pts))


def _window_group_size(n: int, W: int) -> int:
    return min(max(_PHASE_A_BUDGET // max(n, 1), 1), W)


def _chunk_columns(a: torch.Tensor, lo: int, size: int) -> torch.Tensor:
    """Columns [lo, lo + size) of (W, n) digits or signs, contiguous; a last
    chunk that would run past n is the last ``size`` columns instead, with
    the columns an earlier chunk took set to 0 (digit 0: the identity)."""
    n = a.shape[1]
    if lo + size <= n:
        return a[:, lo:lo + size].contiguous()
    out = a[:, n - size:].clone()
    out[:, :lo - (n - size)] = 0
    return out


def _group_tables(curve: CurveSpec, px, py, digits, signs, c: int, m: int,
                  wg: int, pts) -> ProjPoint:
    """Bucket tables (L, Wp, D) of every window of one chunk, in groups of
    ``wg`` windows (the last group padded with digit 0: identity
    buckets), Wp the padded window count."""
    W, n = digits.shape
    parts = []
    for g in range(0, W, wg):
        d, s = digits[g:g + wg], signs[g:g + wg]
        if d.shape[0] < wg:
            extra = wg - d.shape[0]
            d = torch.cat([d, d.new_zeros((extra, n))])
            s = torch.cat([s, s.new_zeros((extra, n))])
        parts.append(_bucket_tables(curve, px, py, d, s, c, m, pts))
    if len(parts) == 1:
        return parts[0]
    return ProjPoint(*(torch.cat([p[i] for p in parts], dim=1)
                       for i in range(3)))


def window_sums(curve: CurveSpec, px, py, digits, signs, c: int,
                pts=None, chunk_n: int | None = None) -> ProjPoint:
    """Per-window sums G_w as (L, W) coordinates.

    Points run in chunks of ``chunk_n`` (default :data:`CHUNK_N`), a
    chunk's windows in groups of at most _PHASE_A_BUDGET / chunk_n, which
    bounds the staged memory (one group up to 2^20 points).  Each chunk
    yields its dense bucket tables; the chunks' tables are summed with one
    complete add each (buckets are sums, so the chunks' order does not
    matter), and the weighted reduction runs once.  A last chunk that
    would run past n takes the last ``chunk_n`` points with the digits of
    those an earlier chunk took set to 0, so every chunk has one shape and
    the cached point-major table is sliced by rows, never copied.  ``pts``
    is phase_a.point_major(px, py) if the caller holds it.  On the card
    above ``chunk_n``: phase A, hist and the bucket assembly launch once a
    chunk and group, padd chunks - 1 times, wscan twice."""
    W, n = digits.shape
    size = min(n, CHUNK_N if chunk_n is None else chunk_n)
    if pts is None and not _ext.on_cpu("window_sums", px):
        pts = phase_a.point_major(px, py)          # once for every chunk
    wg = _window_group_size(size, W)
    m = default_lanes(size, wg, phase_a.resident_threads(curve, px.device))
    acc = None
    for lo in range(0, n, size):
        at = min(lo, n - size)                      # the chunk's first point
        part = _group_tables(
            curve, px[:, at:at + size], py[:, at:at + size],
            _chunk_columns(digits, lo, size), _chunk_columns(signs, lo, size),
            c, m, wg, None if pts is None else pts[at:at + size])
        acc = part if acc is None else cp.add(curve, acc, part)
    sums = red.weighted_window_sum(curve, acc)
    return ProjPoint(*(a[:, :W] for a in sums))


def window_sums_fn(curve: CurveSpec, c: int):
    """(px, py, scalars[, pts]) -> window sums (L, W) x3: the device part
    of the byte-API MSM; the Horner tail runs on the host."""
    def fn(px, py, scalars, pts=None):
        mags, negs = signed_digit_arrays(curve.fr, scalars, c)
        return window_sums(curve, px, py, mags, negs, c, pts)
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


def horner(curve: CurveSpec, sums: ProjPoint, c: int) -> ProjPoint:
    """Combine (L, W, *batch) window sums most significant window first, c
    doublings and one complete add a window, on the sums' device (the
    point_ops kernel on the card, 2W launches: a window's c doublings are
    one pdbl launch, then one padd): sum_w 2^(c w) G_w as (L, *batch)."""
    acc = cp.identity(curve, tuple(sums.x.shape[2:]), sums.x.device)
    for w in reversed(range(sums.x.shape[1])):
        acc = point_kernels.pdbl(curve, acc, c)
        acc = cp.add(curve, acc, ProjPoint(*(a[:, w] for a in sums)))
    return acc


def msm(curve: CurveSpec, px, py, scalars, c: int | None = None
        ) -> ProjPoint:
    """sum_i s_i P_i as one projective point (L,) on the tensors' device.
    ``px``, ``py``: (L, n) canonical Montgomery affine coordinates;
    ``scalars``: (8, n) Montgomery scalar words (any value below 2^256).
    The window sums run as in the byte API (chunked above
    :data:`CHUNK_N`), Horner on the device (:func:`horner`)."""
    n = px.shape[-1]
    if c is None:
        c = window_bits(max(n - 1, 1).bit_length(), bits=curve.fr.bits)
    mags, negs = signed_digit_arrays(curve.fr, scalars, c)
    return horner(curve, window_sums(curve, px, py, mags, negs, c), c)
