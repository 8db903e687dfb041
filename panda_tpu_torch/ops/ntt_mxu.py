"""The four-step NTT plan: transforms as byte-digit matrix products.

Counterpart of ``panda_tpu/ops/ntt_mxu.py`` (the name is kept so a reader
finds the counterpart; the port has no MXU).  Every multiplication in an NTT
is by a known constant, so a whole length-K transform (K <= 2^MAXK) is one
linear map, applied by ``ntt_fused.dft_apply_fused``.  Larger transforms use
the four-step recursion with the same splits as the JAX package (top-down,
log_a = MAXK at every level): a batched length-B pass, a transpose, the
inter-step twiddle w^(j1 k2) (varies per element: ``fmul``), then the batched
length-A pass.  Natural order in and out; no bit reversal anywhere.  The
inverse's n^-1 scale rides in the top level's matrix.

Value bounds: a DFT pass takes any words below 2^256 and returns values in
[0, 2p) ([0, p) for BLS12-381 Fr, whose values stay below p:
``mont.canon``); ``fmul`` takes those times the canonical table (< p) to
[0, 2p) ([0, p));
the top level's outer pass ends with one conditional subtraction of p, so
the output is canonical and its words are the wire bytes.
"""

from __future__ import annotations

import torch

from ..fields import mont
from ..fields.config import FieldSpec
from . import fmul as fmul_ops
from . import ntt_fused

MAXK = 5


def t1_table(spec: FieldSpec, w: int, la: int, lb: int,
             device=None) -> torch.Tensor:
    """T1t[j1, k2] = w^(j1 k2) as canonical Montgomery words (W, A, B): the
    JAX package's ``FusedNttPlan._t1_table`` transposed to (L, A, B), as
    ``MxuNttPlan`` stores it.

    Built on ``device`` by doubling each row, [b^0..b^(s-1)] -> times b^s,
    with ``fmul`` (the kernel on a GPU): log2(B) products instead of a host
    loop over A B big integers."""
    A, B, p = 1 << la, 1 << lb, spec.modulus

    def words(vals):                       # (W, A, 1) Montgomery words
        w_ = mont.ints_to_words(spec, [spec.to_wire_int(v) for v in vals])
        return mont.words_tensor(w_, device).unsqueeze(-1)

    W = mont.n_words(spec)
    rows = words([1] * A)
    s = 1
    while s < B:
        step = words([pow(w, j1 * s, p) for j1 in range(A)]).expand(W, A, s)
        nxt = fmul_ops.fmul(spec, rows.reshape(W, -1), step.reshape(W, -1),
                            canonical_out=True)
        rows = torch.cat((rows, nxt.reshape(W, A, s)), dim=2)
        s *= 2
    return rows.contiguous()


class MxuNttPlan:
    """Device tables for one (spec, log_n, omega, scale) transform.

    ``levels``: top-down four-step splits (log_a, log_b, T1t (W, A, B)
    canonical words, outer DFT matrix); ``leaf``: (log_k, matrix).  The
    ``scale`` (n^-1 for the inverse) is absorbed into the TOP level's
    matrix."""

    def __init__(self, spec: FieldSpec, log_n: int, omega: int,
                 scale: int = 1, device=None):
        self.spec = spec
        self.log_n = log_n
        self.levels = []
        p = spec.modulus
        log, w, first = log_n, omega, True
        while log > MAXK:
            la, lb = MAXK, log - MAXK
            A, B = 1 << la, 1 << lb
            mat = ntt_fused.dft_matrix(spec, la, pow(w, B, p),
                                       scale if first else 1, device)
            self.levels.append((la, lb, t1_table(spec, w, la, lb, device),
                                mat))
            log, w, first = lb, pow(w, A, p), False
        self.leaf = (log, ntt_fused.dft_matrix(spec, log, w,
                                               scale if first else 1, device))


def mxu_plan(spec: FieldSpec, log_n: int, inverse: bool = False,
             omega: int | None = None, device=None) -> MxuNttPlan:
    """The plan for a forward (or inverse) transform of size 2^log_n with
    root ``omega`` (plain integer; default: the field's canonical root)."""
    if omega is None:
        omega = spec.root_of_unity(log_n)
    scale = 1
    if inverse:
        omega = pow(omega, -1, spec.modulus)
        scale = pow(1 << log_n, -1, spec.modulus)
    return MxuNttPlan(spec, log_n, omega, scale, device)


def plan_tables(plan: MxuNttPlan):
    """The plan's device tensors: ((T1t, matrix) per level, leaf matrix)."""
    return (tuple((t1t, mat) for _, _, t1t, mat in plan.levels),
            plan.leaf[1])


def _transform(plan: MxuNttPlan, level: int, x: torch.Tensor, tables,
               canonical: bool) -> torch.Tensor:
    """NTT along axis 1 of (W, M, batch) words, natural order in and out;
    ``canonical`` goes to this level's outer pass."""
    spec = plan.spec
    lvl_tabs, leaf_mat = tables
    if level == len(plan.levels):
        return ntt_fused.dft_apply_fused(spec, x, plan.leaf[0], leaf_mat,
                                         canonical)
    la, lb, _, _ = plan.levels[level]
    t1t, mat = lvl_tabs[level]
    A, B = 1 << la, 1 << lb
    W, M, batch = x.shape
    assert M == A * B
    # inner: length-B over j2, then the transpose to (W, A, B, batch)
    y = _transform(plan, level + 1, x.reshape(W, B, A * batch), tables,
                   False)
    z = y.reshape(W, B, A, batch).permute(0, 2, 1, 3).contiguous()
    # four-step twiddle w^(j1 k2), per element
    pre = t1t.unsqueeze(-1).expand(W, A, B, batch)
    z = fmul_ops.fmul(spec, z.reshape(W, -1), pre.reshape(W, -1))
    # outer: length-A pass
    return ntt_fused.dft_apply_fused(spec, z.reshape(W, A, B * batch), la,
                                     mat, canonical).reshape(W, A * B, batch)


def apply_ntt(plan: MxuNttPlan, x: torch.Tensor, tables) -> torch.Tensor:
    """Transform along axis 1 of (W, n) or (W, n, batch) words (any values
    below 2^256) with the plan's tables; canonical output, so its words are
    the wire bytes."""
    W, n = x.shape[:2]
    if n != 1 << plan.log_n or x.dim() > 3:
        raise ValueError(f"apply_ntt: expected (W, 2^{plan.log_n}[, batch]) "
                         f"words, got {tuple(x.shape)}")
    return _transform(plan, 0, x.reshape(W, n, -1), tables,
                      True).reshape(x.shape)
