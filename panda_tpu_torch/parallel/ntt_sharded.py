"""Sharded NTT over the ranks of a ``torch.distributed`` mesh: the
four-step decomposition with three all-to-all transposes.

Counterpart of ``panda_tpu/parallel/ntt_sharded.py``.  With n = n1 n2:

    view x as A[j1, j2] (row-major)                         [rows sharded]
    all_to_all -> columns sharded
    step 1: NTT_n1 along columns (local)
    step 2: twiddle by w^(j2 k1) (local)
    all_to_all -> rows sharded
    step 3: NTT_n2 along rows (local)
    all_to_all -> natural-order output, rows sharded

with X[k1 + n1 k2] = C[k1, k2].  Rank r holds x[r n / D, (r + 1) n / D) and
gets X over the same range.  ``cluster.all_to_all`` is the tiled
``jax.lax.all_to_all``.  Local engines:

* ``mxu``: the four-step byte-digit plans (``ops/ntt_mxu.py``, kernels
  ``dft`` and ``fmul``) for steps 1 and 3, each along axis 1 of
  (W, n_i, batch), and the step-2 twiddle from two factored power tables
  (k1 = kh 2^s + kl: ``ta`` over powers of w^(2^s), ``tb`` over powers of
  w), two ``fmul`` launches;
* ``jnp``: the stagewise butterflies (``ops/ntt._butterfly_stages``, kernel
  ``fmul``) with a full power table for the twiddle.

Both end canonical, so the output bytes equal the single-device
``run_ntt``'s.  ``ntt_sharded_jitted`` has no counterpart: nothing is
jitted.
"""

from __future__ import annotations

import functools

import torch

from ..fields import mont
from ..fields.config import FieldSpec
from ..ops import fmul as fmul_ops
from ..ops import ntt as ntt_ops
from ..ops import ntt_mxu
from . import cluster
from .cluster import Mesh

ENGINES = ("mxu", "jnp")


def _split_log(log_n: int) -> tuple[int, int]:
    log_n1 = log_n // 2
    return log_n1, log_n - log_n1


def _sub_roots(spec: FieldSpec, log_n: int, omega: int | None):
    """(omega, omega_n1 = w^n2, omega_n2 = w^n1)."""
    log_n1, log_n2 = _split_log(log_n)
    if omega is None:
        omega = spec.root_of_unity(log_n)
    p = spec.modulus
    return omega, pow(omega, 1 << log_n2, p), pow(omega, 1 << log_n1, p)


@functools.lru_cache(maxsize=16)
def _mxu_local(spec: FieldSpec, log_n: int, omega: int | None,
               inverse: bool, device: torch.device):
    """The two sub-plans with their tables, and the factored twiddle tables
    with s.  The inverse's n^-1 = n1^-1 n2^-1 rides in the sub-plans' top
    matrices; its twiddles are powers of w^-1."""
    n = 1 << log_n
    log_n1, log_n2 = _split_log(log_n)
    omega, om1, om2 = _sub_roots(spec, log_n, omega)
    plans = []
    for log_k, om in ((log_n1, om1), (log_n2, om2)):
        plan = ntt_mxu.mxu_plan(spec, log_k, inverse, omega=om, device=device)
        plans.append((plan, ntt_mxu.plan_tables(plan)))
    w = pow(omega, -1, spec.modulus) if inverse else omega
    s = (log_n1 + 1) // 2
    ta = ntt_ops._power_table(spec, pow(w, 1 << s, spec.modulus), n >> s,
                              device)                       # (W, n / 2^s)
    tb = ntt_ops._power_table(spec, w, (1 << log_n2) << s, device)
    return plans, s, ta, tb


@functools.lru_cache(maxsize=16)
def _jnp_local(spec: FieldSpec, log_n: int, omega: int | None,
               inverse: bool, device: torch.device):
    """Stagewise tables of the two sub-transforms (with their twiddle
    rows), the full power table of w (w^-1 for the inverse) and, for the
    inverse, n^-1."""
    log_n1, log_n2 = _split_log(log_n)
    omega, om1, om2 = _sub_roots(spec, log_n, omega)
    subs = []
    for log_k, om in ((log_n1, om1), (log_n2, om2)):
        t = ntt_ops.make_tables(spec, log_k, om)
        subs.append((t, t.w_inv_pows(device) if inverse
                     else t.w_pows(device)))
    whole = ntt_ops.make_tables(spec, log_n, omega)
    w = pow(omega, -1, spec.modulus) if inverse else omega
    return (subs, ntt_ops._power_table(spec, w, 1 << log_n, device),
            whole.n_inv(device) if inverse else None)


def ntt_sharded_fn(spec: FieldSpec, mesh: Mesh, axis: str, log_n: int,
                   omega: int | None = None, inverse: bool = False,
                   engine: str = "mxu"):
    """The sharded transform of (W, n / D) words, this rank's contiguous
    chunk of x (any values below 2^256), to its chunk of X, canonical.
    ``omega``: the root (plain integer; default the field's);
    ``inverse`` scales by n^-1; ``engine``: "mxu" or "jnp"."""
    n = 1 << log_n
    log_n1, log_n2 = _split_log(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    d = mesh.shape[axis]
    if n1 % d or n2 % d:
        raise ValueError(f"n1={n1}, n2={n2} must be divisible by mesh size "
                         f"{d}")
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    group = mesh.group(axis)
    dev = mesh.device
    # j2 of this rank's columns, and k1
    j2 = (mesh.index(axis) * (n2 // d)
          + torch.arange(n2 // d, device=dev, dtype=torch.int64))
    k1 = torch.arange(n1, device=dev, dtype=torch.int64)
    W = mont.n_words(spec)

    if engine == "mxu":
        plans, s, ta, tb = _mxu_local(spec, log_n, omega, inverse, dev)
        (p1, tabs1), (p2, tabs2) = plans
        # twiddle indices in step 1's output layout (n1 [k1], n2 / d [j2])
        kh, kl = (k1 >> s)[:, None], (k1 & ((1 << s) - 1))[:, None]
        ia = ((j2[None, :] * kh) % (n >> s)).reshape(-1)
        ib = (j2[None, :] * kl).reshape(-1)                 # < n2 2^s

        def run(x):
            a = x.reshape(W, n1 // d, n2)
            a = cluster.all_to_all(a, 2, 1, group)          # (W, n1, n2/d)
            a = ntt_mxu.apply_ntt(p1, a, tabs1)             # along k1
            flat = a.reshape(W, -1)
            flat = fmul_ops.fmul(spec, flat, ta.index_select(1, ia))
            flat = fmul_ops.fmul(spec, flat, tb.index_select(1, ib))
            a = cluster.all_to_all(flat.reshape(W, n1, n2 // d), 1, 2,
                                   group)                   # (W, n1/d, n2)
            a = ntt_mxu.apply_ntt(p2, a.transpose(1, 2).contiguous(),
                                  tabs2)                    # (W, n2, n1/d)
            a = cluster.all_to_all(a, 1, 2, group)          # (W, n2/d, n1)
            return a.reshape(W, n // d)
        return run

    ((t1, w1), (t2, w2)), wpow, n_inv = _jnp_local(spec, log_n, omega,
                                                   inverse, dev)
    tw_idx = ((j2[:, None] * k1[None, :]) % n).reshape(-1)  # (n2/d, n1)

    def run(x):
        a = mont.reduce_wire(spec, x).reshape(W, n1 // d, n2)
        a = cluster.all_to_all(a, 2, 1, group)              # (W, n1, n2/d)
        a = a.transpose(1, 2).index_select(-1, t1.bitrev(dev))
        a = ntt_ops._butterfly_stages(spec, a, w1, log_n1)  # (W, n2/d, n1)
        a = fmul_ops.fmul(spec, a.reshape(W, -1),
                          wpow.index_select(1, tw_idx))
        a = a.reshape(W, n2 // d, n1).transpose(1, 2)
        a = cluster.all_to_all(a, 1, 2, group)              # (W, n1/d, n2)
        a = a.index_select(-1, t2.bitrev(dev))
        a = ntt_ops._butterfly_stages(spec, a, w2, log_n2)
        a = cluster.all_to_all(a, 2, 1, group)              # (W, n1, n2/d)
        a = ntt_ops._finish(spec, a.transpose(1, 2).contiguous(), n_inv)
        return a.reshape(W, n // d)
    return run
