"""Elementwise point kernels.

Counterpart of ``panda_tpu/ops/point_pallas.py``'s ``padd``/``pmadd``/
``pdbl`` (``csrc/point_ops.cu`` replaces ``_run`` behind them); its
``weighted_scan`` is replaced by ``ops/reduce.weighted_window_sum``
(``csrc/wscan.cu``).

Coordinates are (L, *batch) int32 words, L = ``mont.n_words(curve.fp)``
(8 for BN254, 12 for the BLS curves); the kernels are built for the three
curves of ``_ext.MSM_CURVES`` and take the curve's id.  A launch is one
wave of the build's resident threads (:func:`point_ops_threads`), each
walking the batch with a grid stride; ``pdbl`` takes a count k and doubles
each point k times between one load and one store, so ``msm.horner`` runs
a window's c doublings as one launch.  Each wrapper takes its plain
version (beside it, or the plain formula in ``curves/point.py``) for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..curves import point as cp
from ..curves.config import CurveSpec
from ..curves.point import AffinePoint, ProjPoint
from . import _ext
from ._ext import I32, I64, P

# The ops in the order of ptt_point_ops_threads' ids (3 op + curve).
OPS = ("padd", "pmadd", "pdbl")


def point_ops_threads(curve: CurveSpec, op: str,
                      device: torch.device) -> int:
    """Threads of one full wave of csrc/point_ops.cu's ``op`` (one of
    :data:`OPS`) for ``curve`` on the card ``device``, as the build's
    registers allow."""
    cid = _ext.kernel_field(op, curve, _ext.MSM_CURVES)
    return _ext.resident_threads("point_ops", "ptt_point_ops_threads",
                                 3 * OPS.index(op) + cid, device)


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1).contiguous()


def _run(curve: CurveSpec, op: str, arrays, shape, counts=()):
    """Flatten the batch, launch ``ptt_<op>`` of point_ops.cu (``counts``:
    its int arguments after n, pdbl's k), restore."""
    symbol = f"ptt_{op}"
    cid = _ext.kernel_field(symbol, curve, _ext.MSM_CURVES)
    flat = [_flat(a) for a in arrays]
    _ext.check_cuda(symbol, *flat)
    _ext.check_words(symbol, curve.fp, flat[0])
    outs = [torch.empty_like(flat[0]) for _ in range(3)]
    dev = flat[0].device
    _ext.launch("point_ops", symbol,
                [P] * (len(flat) + 3) + [I64] + [I32] * (len(counts) + 2),
                [t.data_ptr() for t in flat + outs] +
                [flat[0].shape[1], *counts, cid,
                 point_ops_threads(curve, op, dev)], dev)
    return ProjPoint(*(o.reshape(shape) for o in outs))


def padd(curve: CurveSpec, p: ProjPoint, q: ProjPoint) -> ProjPoint:
    """Complete projective add of (L, *batch) coordinate triples."""
    if _ext.on_cpu("padd", p.x):
        return cp.add_plain(curve, p, q)
    shape = torch.broadcast_shapes(*(a.shape for a in (*p, *q)))
    arrays = [a.expand(shape) for a in (*p, *q)]
    return _run(curve, "padd", arrays, shape)


def pmadd(curve: CurveSpec, p: ProjPoint, q: AffinePoint) -> ProjPoint:
    """Complete mixed add: p projective triple, q affine pair."""
    if _ext.on_cpu("pmadd", p.x):
        return cp.madd_plain(curve, p, q)
    shape = torch.broadcast_shapes(*(a.shape for a in (*p, *q)))
    arrays = [a.expand(shape) for a in (*p, *q)]
    return _run(curve, "pmadd", arrays, shape)


def pdbl_plain(curve: CurveSpec, p: ProjPoint, k: int = 1) -> ProjPoint:
    """The plain version of :func:`pdbl`: the complete doubling k times."""
    for _ in range(k):
        p = cp.dbl_plain(curve, p)
    return p


def pdbl(curve: CurveSpec, p: ProjPoint, k: int = 1) -> ProjPoint:
    """2^k p by k complete doublings of an (L, *batch) coordinate triple,
    k >= 1: on the card one launch, which loads each point once, doubles it
    k times in registers and stores it once."""
    if k < 1:
        raise ValueError(f"pdbl: k must be >= 1, got {k}")
    if _ext.on_cpu("pdbl", p.x):
        return pdbl_plain(curve, p, k)
    return _run(curve, "pdbl", list(p), p.x.shape, (k,))
