"""Elementwise point kernels and the weighted bucket scan.

Counterpart of ``panda_tpu/ops/point_pallas.py``:

* ``padd``/``pmadd``/``pdbl`` (``csrc/point_ops.cu``) replace ``_run``
  behind the TPU's ``padd``/``pmadd``/``pdbl``;
* ``weighted_scan`` (``csrc/wscan.cu``) replaces ``weighted_scan``.

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


# ---------------------------------------------------------------------------
# Weighted bucket scan
# ---------------------------------------------------------------------------

def weighted_scan_plain(curve: CurveSpec, b: ProjPoint):
    """Plain version: ``b`` coordinates (L, S, N); reverse loop over S with
    run += B_s, wsum += run.  Returns (run, wsum) triples of (L, N)."""
    S, N = b.x.shape[1:]
    run = cp.identity(curve, (N,), b.x.device)
    wsum = cp.identity(curve, (N,), b.x.device)
    for s in range(S - 1, -1, -1):
        run = cp.add_plain(curve, run, ProjPoint(*(a[:, s] for a in b)))
        wsum = cp.add_plain(curve, wsum, run)
    return run, wsum


def weighted_scan(curve: CurveSpec, b: ProjPoint):
    """Reverse weighted scan over the step axis of (L, S, N) bucket
    coordinates: run = sum_s B_s, wsum = sum_s (s + 1) B_s, each (L, N)."""
    if _ext.on_cpu("weighted_scan", b.x):
        return weighted_scan_plain(curve, b)
    cid = _ext.kernel_field("weighted_scan", curve, _ext.MSM_CURVES)
    b = ProjPoint(*(a.contiguous() for a in b))
    _ext.check_cuda("weighted_scan", *b)
    _ext.check_words("weighted_scan", curve.fp, b.x)
    L, S, N = b.x.shape
    outs = [torch.empty((L, N), dtype=torch.int32, device=b.x.device)
            for _ in range(6)]
    _ext.launch("wscan", "ptt_weighted_scan", [P] * 9 + [I64, I64, I32],
                [t.data_ptr() for t in (*b, *outs)] + [N, S, cid], b.x.device)
    return ProjPoint(*outs[:3]), ProjPoint(*outs[3:])
