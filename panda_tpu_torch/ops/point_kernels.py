"""Elementwise point kernels.

Counterpart of ``panda_tpu/ops/point_pallas.py``'s ``padd``/``pmadd``/
``pdbl`` (``csrc/point_ops.cu`` replaces ``_run`` behind them); its
``weighted_scan`` is replaced by ``ops/reduce.weighted_window_sum``
(``csrc/wscan.cu``).

Coordinates are (L, *batch) int32 words, L = ``mont.n_words(curve.fp)``
(8 for BN254, 12 for the BLS curves); the kernels are built for the three
curves of ``_ext.MSM_CURVES`` and take the curve's id.  Each wrapper takes
its plain version (beside it, or the plain formula in ``curves/point.py``)
for CPU tensors only; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..curves import point as cp
from ..curves.config import CurveSpec
from ..curves.point import AffinePoint, ProjPoint
from . import _ext
from ._ext import I32, I64, P


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1).contiguous()


def _run(curve: CurveSpec, symbol: str, arrays, shape):
    """Flatten the batch, launch ``symbol`` of point_ops.cu, restore."""
    cid = _ext.kernel_field(symbol, curve, _ext.MSM_CURVES)
    flat = [_flat(a) for a in arrays]
    _ext.check_cuda(symbol, *flat)
    _ext.check_words(symbol, curve.fp, flat[0])
    outs = [torch.empty_like(flat[0]) for _ in range(3)]
    _ext.launch("point_ops", symbol, [P] * (len(flat) + 3) + [I64, I32],
                [t.data_ptr() for t in flat + outs] + [flat[0].shape[1], cid],
                flat[0].device)
    return ProjPoint(*(o.reshape(shape) for o in outs))


def padd(curve: CurveSpec, p: ProjPoint, q: ProjPoint) -> ProjPoint:
    """Complete projective add of (L, *batch) coordinate triples."""
    if _ext.on_cpu("padd", p.x):
        return cp.add_plain(curve, p, q)
    shape = torch.broadcast_shapes(*(a.shape for a in (*p, *q)))
    arrays = [a.expand(shape) for a in (*p, *q)]
    return _run(curve, "ptt_padd", arrays, shape)


def pmadd(curve: CurveSpec, p: ProjPoint, q: AffinePoint) -> ProjPoint:
    """Complete mixed add: p projective triple, q affine pair."""
    if _ext.on_cpu("pmadd", p.x):
        return cp.madd_plain(curve, p, q)
    shape = torch.broadcast_shapes(*(a.shape for a in (*p, *q)))
    arrays = [a.expand(shape) for a in (*p, *q)]
    return _run(curve, "ptt_pmadd", arrays, shape)


def pdbl(curve: CurveSpec, p: ProjPoint) -> ProjPoint:
    """Complete doubling of an (L, *batch) coordinate triple."""
    if _ext.on_cpu("pdbl", p.x):
        return cp.dbl_plain(curve, p)
    return _run(curve, "ptt_pdbl", list(p), p.x.shape)
