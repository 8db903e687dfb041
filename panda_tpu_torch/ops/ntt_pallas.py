"""The radix-2 NTT engine (``PANDA_NTT_IMPL=pallas``): batched shared-memory
passes of up to 2^8 butterfly stages, composed by the four-step recursion.

Counterpart of ``panda_tpu/ops/ntt_pallas.py`` (the name is kept so a reader
finds the counterpart); the kernel is ``csrc/small_ntt.cu`` (BN254 Fr,
BLS12-377 Fr and BLS12-381 Fr).  With n = A B and w the length-n root,

    X[B k1 + k2] = NTT_A( w^(j1 k2) NTT_B(x[j1 + A j2], over j2), over j1 )

as in the JAX package, with its splits (``maxk = 8``, balanced
``la = min(maxk, (log + 1) // 2)``).  What differs, and why:

* the bit reversal is folded into the kernel's load (no gather before each
  pass), so the T1 table is stored in natural order, (W, A, B), and built on
  the device by ``ntt_mxu.t1_table``;
* the inter-level twiddle is read from that (W, A, B) table by column
  k2 = c // batch, not from a broadcast copy the size of the data;
* the transpose between levels is folded into the outer pass's load: it
  reads the inner level's output as the view (W, B, A, batch) where it
  lies, so the recursion copies nothing between passes;
* every value stays in [0, 2p), or [0, p) for BLS12-381 Fr
  (``mont.canon``) (no lazy bounds, no closing multiply by ONE); the first
  pass (the leaf) brings any input word below 2^256 to
  [0, p) at load, and the top pass applies the inverse's n^-1 and the
  canonical subtraction at store, so no separate pass follows.

Natural order in and out; the output is canonical, byte-equal to the
four-step engine's (``ops/ntt_mxu.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields import mont
from ..fields.config import FieldSpec
from . import _ext
from .ntt_mxu import t1_table
from ._ext import I32, I64, P

MAX_LOG_K = 8          # the kernel's largest pass: K = 256, 80 KB per block


def stage_twiddle_rows(spec: FieldSpec, log_k: int, omega: int,
                       device=None) -> torch.Tensor:
    """Stacked per-stage DIT twiddle rows, canonical Montgomery words (W, K).

    Stage s (half-block m = 2^s) multiplies the odd half by w^(t K / (2 m))
    for t in [0, m); its m rows live at [m - 1, 2 m - 1).  K - 1 rows, padded
    to K.  (The JAX package broadcasts the same rows over its 128 lanes.)"""
    K, p = 1 << log_k, spec.modulus
    vals = [0] * K
    for s in range(log_k):
        m = 1 << s
        for t in range(m):
            vals[m - 1 + t] = spec.to_wire_int(pow(omega, t * (K // (2 * m)),
                                                   p))
    return mont.words_tensor(mont.ints_to_words(spec, vals), device)


def _bitrev(log_k: int) -> np.ndarray:
    n = 1 << log_k
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for _ in range(log_k):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    return rev.astype(np.int32)


def natural_layout(x: torch.Tensor) -> torch.Tensor:
    """A pass's input as (W, K, nb) words in natural order: ``x`` itself,
    or for the four-step inner output view (W, nb / batch, K, batch) the
    element (j, c) at word (c // batch) K batch + j batch + c mod batch of
    each plane (the kernel's own indexing)."""
    if x.dim() == 3:
        return x
    W, G, K, batch = x.shape
    nb = G * batch
    j = torch.arange(K, device=x.device).unsqueeze(1)
    c = torch.arange(nb, device=x.device).unsqueeze(0)
    at = c // batch * K * batch + j * batch + c % batch
    return x.reshape(W, -1)[:, at.reshape(-1)].reshape(W, K, nb)


def small_ntt_batch_plain(spec: FieldSpec, x: torch.Tensor, log_k: int,
                          tw_rows: torch.Tensor,
                          pre_tw: torch.Tensor | None = None,
                          scale: torch.Tensor | None = None,
                          reduce_in: bool = False,
                          canonical_out: bool = False) -> torch.Tensor:
    """Plain version: the kernel's steps in its order, on whole tensors."""
    x = natural_layout(x)
    W, K, nb = x.shape
    if reduce_in:
        x = mont.reduce_wire(spec, x)
    if pre_tw is not None:
        B = pre_tw.shape[2]
        pre = pre_tw.unsqueeze(-1).expand(W, K, B, nb // B).reshape(W, K, nb)
        x = mont.mul(spec, x, pre)
    x = x[:, torch.from_numpy(_bitrev(log_k)).to(x.device).long()]
    for s in range(log_k):
        m = 1 << s
        xr = x.reshape(W, K // (2 * m), 2, m, nb)
        u, v = xr[:, :, 0], xr[:, :, 1]
        if s:
            tw = tw_rows[:, m - 1:2 * m - 1].reshape(W, 1, m, 1)
            v = mont.mul(spec, v, tw)
        x = torch.stack((mont.add(spec, u, v), mont.sub(spec, u, v)),
                        dim=2).reshape(W, K, nb)
    if scale is not None:
        x = mont.mul(spec, x, scale.reshape(W, 1, 1))
    return mont.canonical(spec, x) if canonical_out else x


def small_ntt_batch(spec: FieldSpec, x: torch.Tensor, log_k: int,
                    tw_rows: torch.Tensor,
                    pre_tw: torch.Tensor | None = None,
                    scale: torch.Tensor | None = None,
                    reduce_in: bool = False,
                    canonical_out: bool = False) -> torch.Tensor:
    """Batch of length-K NTTs along the K axis of ``x``, natural order in
    and out, K = 2^log_k: (W, K, nb) words, or the four-step inner output
    view (W, nb / batch, K, batch), whose column c = k2 batch + b is
    x[:, k2, :, b] (read where it lies, no transpose).  Returns (W, K, nb).

    ``tw_rows``: :func:`stage_twiddle_rows` (W, K) for the pass's root.
    ``pre_tw`` (optional, (W, K, B) canonical words with B | nb): element
    (j, c) is multiplied by pre_tw[:, j, c // (nb / B)] at load.  ``scale``
    (optional, (W,) canonical words): every output is multiplied by it.
    Inputs below 2p, or any word below 2^256 with ``reduce_in``; outputs
    below 2p, or canonical with ``canonical_out``.  BLS12-381 Fr
    (``mont.canon``): inputs below p (or any word with ``reduce_in``),
    outputs below p."""
    if x.dim() == 4:
        W, G, K, run = x.shape
        nb = G * run
    else:
        W, K, nb = x.shape
        run = nb
    if K != 1 << log_k or tw_rows.shape != (W, K):
        raise ValueError(f"small_ntt_batch: x {tuple(x.shape)} and twiddle "
                         f"rows {tuple(tw_rows.shape)} do not match "
                         f"K = 2^{log_k}")
    if pre_tw is not None and (pre_tw.shape[:2] != (W, K)
                               or nb % pre_tw.shape[2]):
        raise ValueError(f"small_ntt_batch: pre-twiddle table "
                         f"{tuple(pre_tw.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if _ext.on_cpu("small_ntt_batch", x):
        return small_ntt_batch_plain(spec, x, log_k, tw_rows, pre_tw, scale,
                                     reduce_in, canonical_out)
    field = _ext.kernel_field("small_ntt_batch", spec, _ext.NTT_FIELDS)
    if W != 8 or not 1 <= log_k <= MAX_LOG_K:
        raise ValueError(f"small_ntt_batch: the kernel takes 8 words and "
                         f"2 <= K <= {1 << MAX_LOG_K}")
    if scale is not None and scale.shape != (W,):
        raise ValueError("small_ntt_batch: the scale must be (8,) words")
    x, tw_rows = x.contiguous(), tw_rows.contiguous()
    pre = pre_tw.contiguous() if pre_tw is not None else None
    sc = scale.contiguous() if scale is not None else None
    _ext.check_cuda("small_ntt_batch", x, tw_rows,
                    *(t for t in (pre, sc) if t is not None))
    out = torch.empty((W, K, nb), dtype=x.dtype, device=x.device)
    _ext.launch("small_ntt", "ptt_small_ntt",
                [P, P, P, P, P, I64, I32, I64, I64, I32, I32, I32, I32],
                [x.data_ptr(), tw_rows.data_ptr(),
                 pre.data_ptr() if pre is not None else None,
                 sc.data_ptr() if sc is not None else None, out.data_ptr(),
                 nb, log_k, run, pre.shape[2] if pre is not None else 1,
                 int(reduce_in), int(canonical_out), field,
                 small_ntt_threads(field, log_k, x.device)], x.device)
    return out


def small_ntt_threads(field: int, log_k: int, device: torch.device) -> int:
    """Threads of one full wave of csrc/small_ntt.cu's pass of 2^log_k for
    NTT field id ``field`` on the card ``device``, as the build's
    registers and the pass's shared memory allow."""
    return _ext.resident_threads("small_ntt", "ptt_small_ntt_threads",
                                 16 * field + log_k, device)


def small_ntt_geometry(spec: FieldSpec, log_k: int, nb: int,
                       device: torch.device) -> dict:
    """How a pass of 2^log_k over nb columns launches on ``device``:
    elements a thread (r), rounds, columns a tile, tiles, blocks (the same
    number of tiles a block), threads a block and the blocks of one wave."""
    field = _ext.kernel_field("small_ntt_batch", spec, _ext.NTT_FIELDS)
    wave = small_ntt_threads(field, log_k, device)
    out = (ctypes.c_int64 * 6)()
    f = _ext._fn("small_ntt", "ptt_small_ntt_geometry",
                 [I32, I64, I32, ctypes.POINTER(ctypes.c_int64)])
    f(log_k, nb, wave, out)
    r, rounds, cols, tiles, blocks, threads = out
    return {"r": r, "rounds": rounds, "cols": cols, "tiles": tiles,
            "blocks": blocks, "threads": threads,
            "wave_blocks": wave // threads}


def splits(log_n: int, maxk: int = 8) -> tuple:
    """The four-step recursion of a 2^log_n transform: its levels' (log_a,
    log_b), top-down, and its leaf's log_k.  The JAX package's balanced
    splits: every factor >= 8 rows; a 4-5 bit residue becomes a slightly
    oversized leaf."""
    levels, log = [], log_n
    while log > maxk and log >= 6:
        la = min(maxk, (log + 1) // 2)
        levels.append((la, log - la))
        log -= la
    return levels, log


def pass_shapes(log_n: int, maxk: int = 8) -> list:
    """The passes a radix-2 transform of 2^log_n launches, in launch order
    (the leaf first, the top pass last): (log_k, nb, batch, T1 table), where
    batch is that of the inner output view (W, nb / batch, K, batch) the
    pass reads, 0 for the leaf's natural (W, K, nb) layout."""
    levels, leaf = splits(log_n, maxk)
    out = [(leaf, 1 << (log_n - leaf), 0, False)]
    for i in reversed(range(len(levels))):
        la = levels[i][0]
        batch = 1 << sum(lv[0] for lv in levels[:i])
        out.append((la, 1 << (log_n - la), batch, True))
    return out


class FusedNttPlan:
    """Device tables for one (spec, log_n, omega, maxk) radix-2 transform.

    ``levels`` lists the four-step recursion top-down: (log_a, log_b,
    T1t (W, A, B) with T1t[j1, k2] = w^(j1 k2), the outer pass's stage
    rows); ``leaf``: (log_k, stage rows).  ``scale``: None, or the
    inverse's n^-1 as (W,) words, applied by the top pass."""

    def __init__(self, spec: FieldSpec, log_n: int, omega: int,
                 maxk: int = 8, scale: int = 1, device=None):
        self.spec = spec
        self.log_n = log_n
        self.maxk = maxk
        self.levels = []
        assert log_n >= 3, "fused NTT needs n >= 8"
        p = spec.modulus
        w = omega
        levels, log = splits(log_n, maxk)
        for la, lb in levels:
            A, B = 1 << la, 1 << lb
            self.levels.append((la, lb, t1_table(spec, w, la, lb, device),
                                stage_twiddle_rows(spec, la, pow(w, B, p),
                                                   device)))
            w = pow(w, A, p)
        self.leaf = (log, stage_twiddle_rows(spec, log, w, device))
        self.scale = None if scale % p == 1 else mont.words_tensor(
            mont.ints_to_words(spec, [spec.to_wire_int(scale)]),
            device).reshape(-1)


def fused_plan(spec: FieldSpec, log_n: int, inverse: bool = False,
               maxk: int = 8, omega: int | None = None,
               device=None) -> FusedNttPlan:
    """The plan of a forward (or inverse, with n^-1) transform of size
    2^log_n with root ``omega`` (plain integer; default: the field's
    canonical root), its tables on ``device``."""
    if omega is None:
        omega = spec.root_of_unity(log_n)
    scale = 1
    if inverse:
        omega = pow(omega, -1, spec.modulus)
        scale = pow(1 << log_n, -1, spec.modulus)
    return FusedNttPlan(spec, log_n, omega, maxk, scale, device)


def _transform(plan: FusedNttPlan, level: int, x: torch.Tensor) -> torch.Tensor:
    """NTT along axis 1 of (W, M, batch) words, natural order in and out.
    The leaf pass runs first and reduces the input words; the top pass
    (level 0) scales and canonicalises."""
    spec = plan.spec
    top = level == 0
    scale = plan.scale if top else None
    if level == len(plan.levels):
        log_k, tw = plan.leaf
        return small_ntt_batch(spec, x, log_k, tw, scale=scale,
                               reduce_in=True, canonical_out=top)
    la, lb, t1t, tw = plan.levels[level]
    A, B = 1 << la, 1 << lb
    W, M, batch = x.shape
    assert M == A * B
    # inner: length-B over j2; the outer pass reads its output (W, B, A,
    # batch) as rows j1, columns (k2, batch) where it lies, and the twiddle
    # w^(j1 k2) rides its load
    y = _transform(plan, level + 1, x.reshape(W, B, A * batch))
    out = small_ntt_batch(spec, y.reshape(W, B, A, batch), la, tw,
                          pre_tw=t1t, scale=scale, canonical_out=top)
    return out.reshape(W, A * B, batch)


def fused_ntt(spec: FieldSpec, x: torch.Tensor, log_n: int,
              inverse: bool = False, maxk: int = 8, omega: int | None = None,
              plan: FusedNttPlan | None = None) -> torch.Tensor:
    """Radix-2 NTT along the LAST axis of (W, *batch, n) words (any values
    below 2^256), on their device; canonical output (the inverse includes
    n^-1), byte-equal to the four-step engine's.  ``plan`` (from
    :func:`fused_plan` for the same arguments and device) skips building
    the tables."""
    if plan is None:
        plan = fused_plan(spec, log_n, inverse, maxk, omega, x.device)
    n = 1 << log_n
    W, batch = x.shape[0], x.shape[1:-1]
    xb = x.reshape(W, -1, n).transpose(1, 2).contiguous()      # (W, n, nb)
    y = _transform(plan, 0, xb)
    return y.transpose(1, 2).reshape(x.shape)
