"""MSM phase A: the sorted-run bucket-accumulation scan.

Counterpart of ``panda_tpu/ops/phase_a_pallas.py``; the kernel is
``csrc/phase_a.cu`` (one thread per (window, lane), accumulator in
registers, the base gather and the y negation in-kernel, the next step's
loads issued before each mixed add), built for the three curves of
``_ext.MSM_CURVES``.

Inputs (int32 tensors of uint32 words), with S steps of m lanes and
L = ``mont.n_words(curve.fp)`` words a coordinate (8 for BN254, 12 for the
BLS curves):
  keys, sidx   (W, S, m)  sorted digits; point index | sign << 31
  px, py       (L, n)     affine bases (Montgomery, canonical)
Outputs:
  ekeys        (W, S, m)  key of the run that ended before each step
                          (``dead`` where none did)
  epts         ProjPoint of (L, W, S, m): that run's sum, defined only
                          where ``ekeys != dead`` (the kernel stores a sum
                          only where a run ends and leaves the rest
                          unwritten; the plain version writes the identity
                          there)
  tkeys        (W, m)     each lane's final key
  tpts         ProjPoint of (L, W, m): each lane's final run sum
"""

from __future__ import annotations

import torch

from ..curves import point as cp
from ..curves.config import CurveSpec
from ..curves.point import AffinePoint, ProjPoint
from ..fields import mont
from . import _ext
from ._ext import I32, I64, P

INIT_KEY = -1          # 0xFFFFFFFF as int32: "no key yet"


def scan_plain(curve: CurveSpec, keys, sidx, px, py, dead: int):
    """Plain version: the same per-lane loop, vectorised over lanes."""
    W, S, m = keys.shape
    dev = keys.device
    idx = (sidx & 0x7FFFFFFF).to(torch.int64)
    neg = sidx < 0
    ident = cp.identity(curve, (W, m), dev)
    acc, akey = ident, torch.full((W, m), INIT_KEY, dtype=torch.int32,
                                  device=dev)
    ekeys, eps = [], []
    for s in range(S):
        k = keys[:, s]
        qx, qy = px[:, idx[:, s]], py[:, idx[:, s]]          # (L, W, m)
        qy = torch.where(neg[:, s].unsqueeze(0), mont.neg(curve.fp, qy), qy)
        same = k == akey
        emit = ~same & (akey != INIT_KEY)
        ekeys.append(torch.where(emit, akey, torch.full_like(akey, dead)))
        eps.append(cp.select(emit, acc, ident))
        acc = cp.madd_plain(curve, cp.select(same, acc, ident),
                            AffinePoint(qx, qy))
        akey = k
    epts = ProjPoint(*(torch.stack([e[i] for e in eps], dim=2)
                       for i in range(3)))
    return torch.stack(ekeys, dim=1), epts, akey, acc


def scan(curve: CurveSpec, keys, sidx, px, py, dead: int):
    """Phase A over all (window, lane) pairs; see the module docstring."""
    if _ext.on_cpu("phase_a", keys):
        return scan_plain(curve, keys, sidx, px, py, dead)
    cid = _ext.kernel_field("phase_a", curve, _ext.MSM_CURVES)
    keys, sidx, px, py = (a.contiguous() for a in (keys, sidx, px, py))
    _ext.check_cuda("phase_a", keys, sidx, px, py)
    W, S, m = keys.shape
    if sidx.shape != keys.shape or px.shape != py.shape:
        raise ValueError("phase_a: shape mismatch")
    _ext.check_words("phase_a", curve.fp, px)
    L, n = px.shape
    dev = keys.device
    ekeys = torch.empty_like(keys)
    epts = [torch.empty((L, W, S, m), dtype=torch.int32, device=dev)
            for _ in range(3)]
    tkeys = torch.empty((W, m), dtype=torch.int32, device=dev)
    tpts = [torch.empty((L, W, m), dtype=torch.int32, device=dev)
            for _ in range(3)]
    _ext.launch("phase_a", "ptt_phase_a",
                [P] * 4 + [I64] + [P] * 8 + [I64] * 3 + [I32, I32],
                [keys.data_ptr(), sidx.data_ptr(), px.data_ptr(),
                 py.data_ptr(), n, ekeys.data_ptr(),
                 *(a.data_ptr() for a in epts), tkeys.data_ptr(),
                 *(a.data_ptr() for a in tpts), W, m, S, dead, cid], dev)
    return ekeys, ProjPoint(*epts), tkeys, ProjPoint(*tpts)
