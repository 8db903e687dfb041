"""MSM phase A: the sorted-run bucket-accumulation scan.

Counterpart of ``panda_tpu/ops/phase_a_pallas.py``; the kernel is
``csrc/phase_a.cu`` (one thread per (window, lane), accumulator in
registers, the base points gathered from a point-major (n, 2L) table by
``cp.async`` copies a few steps ahead into a ring in shared memory, the
y negation in-kernel), built for the three curves of ``_ext.MSM_CURVES``.
The caller may pass the point-major table (:func:`point_major`; a session
builds it once per cached base set); otherwise the wrapper builds it from
``(px, py)`` on the device (one transpose of the bases, 64 or 96 MiB at
2^20).

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
# One wave of the plain version on the CPU, where the lane count moves no
# result, only the plain loop's width and length: 2^16 lanes.
CPU_THREADS = 1 << 16


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


def point_major(px, py):
    """(L, n) word tables x and y -> the (n, 2L) table the kernel gathers
    from: row i is x_i's words then y_i's."""
    return torch.cat([px, py]).t().contiguous()


def resident_threads(curve: CurveSpec, device: torch.device) -> int:
    """Threads of one full wave of phase A for ``curve`` on ``device``: on
    the card, what the kernel's build allows at once (132 SMs x 4 blocks of
    128 for BN254 and x 3 for the BLS curves on the H100); on the CPU,
    CPU_THREADS."""
    if torch.device(device).type == "cpu":
        return CPU_THREADS
    return _ext.resident_threads(
        "phase_a", "ptt_phase_a_threads",
        _ext.kernel_field("phase_a", curve, _ext.MSM_CURVES), device)


def scan(curve: CurveSpec, keys, sidx, px, py, dead: int, pts=None):
    """Phase A over all (window, lane) pairs; see the module docstring.
    ``pts`` is ``point_major(px, py)`` if the caller holds it (a row slice
    of a session's table is one); the wrapper then reads (px, py) only
    for their shape."""
    if _ext.on_cpu("phase_a", keys):
        return scan_plain(curve, keys, sidx, px, py, dead)
    cid = _ext.kernel_field("phase_a", curve, _ext.MSM_CURVES)
    keys, sidx = keys.contiguous(), sidx.contiguous()
    W, S, m = keys.shape
    if sidx.shape != keys.shape or px.shape != py.shape:
        raise ValueError("phase_a: shape mismatch")
    _ext.check_words("phase_a", curve.fp, px)
    L = px.shape[0]
    dev = keys.device
    ekeys = torch.empty_like(keys)
    epts = [torch.empty((L, W, S, m), dtype=torch.int32, device=dev)
            for _ in range(3)]
    tkeys = torch.empty((W, m), dtype=torch.int32, device=dev)
    tpts = [torch.empty((L, W, m), dtype=torch.int32, device=dev)
            for _ in range(3)]
    if pts is None:
        pts = point_major(px, py)
    elif pts.shape != (px.shape[1], 2 * L):
        raise ValueError("phase_a: pts is not point_major(px, py)")
    _ext.check_cuda("phase_a", keys, sidx, pts)
    _ext.launch("phase_a", "ptt_phase_a",
                [P] * 11 + [I64] * 3 + [I32] * 2,
                [keys.data_ptr(), sidx.data_ptr(), pts.data_ptr(),
                 ekeys.data_ptr(), *(a.data_ptr() for a in epts),
                 tkeys.data_ptr(), *(a.data_ptr() for a in tpts), W, m, S,
                 dead, cid], dev)
    return ekeys, ProjPoint(*epts), tkeys, ProjPoint(*tpts)
