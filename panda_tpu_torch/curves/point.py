"""Branchless point arithmetic (short Weierstrass, a = 0) on torch tensors.

Counterpart of ``panda_tpu/curves/point.py``.  Points are homogeneous
projective triples ``ProjPoint(x, y, z)`` of ``(W, *batch)`` int32 word
tensors (Montgomery form, R = 2^256 for BN254, every value in [0, 2p)); the
identity is (0 : 1 : 0).  The formulas are the complete Renes-Costello-Batina
algorithms 7-9 for a = 0, the same op sequence as the JAX package and as
``csrc/field.cuh``, so the plain version and the kernel agree bit for bit.

``add``/``madd``/``dbl`` dispatch on the tensor's device: a CPU tensor takes
the plain version below, a CUDA tensor always takes the kernel
(``ops/point_kernels.py``); there is no batch-size threshold.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..fields import mont
from .config import CurveSpec


class ProjPoint(NamedTuple):
    """Homogeneous projective point; word tensors (W, *batch)."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class AffinePoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor


def one_words(curve: CurveSpec, batch_shape=(), device=None) -> torch.Tensor:
    """Montgomery 1 (R mod p) broadcast to (W, *batch_shape)."""
    fp = curve.fp
    w = mont.words_tensor(
        mont.ints_to_words(fp, [mont.radix(fp) % fp.modulus]), device)
    return w.view((w.shape[0],) + (1,) * len(batch_shape)).expand(
        (w.shape[0],) + tuple(batch_shape)).contiguous()


def identity(curve: CurveSpec, batch_shape=(), device=None) -> ProjPoint:
    """(0 : 1 : 0) in Montgomery form."""
    one = one_words(curve, batch_shape, device)
    zero = torch.zeros_like(one)
    return ProjPoint(zero, one, zero.clone())


def from_affine(curve: CurveSpec, pt: AffinePoint) -> ProjPoint:
    one = one_words(curve, pt.x.shape[1:], pt.x.device)
    return ProjPoint(pt.x, pt.y, one)


# ---------------------------------------------------------------------------
# Plain formulas (16-bit-limb int64 internally)
# ---------------------------------------------------------------------------

def _ops(curve: CurveSpec):
    f = curve.fp
    return (lambda a, b: mont.mul16(f, a, b),
            lambda a, b: mont.add16(f, a, b),
            lambda a, b: mont.sub16(f, a, b),
            lambda a: mont.mul_small16(f, a, curve.b3))


def _words(*vals):
    return tuple(mont.from_l16(v) for v in vals)


def add_plain(curve: CurveSpec, p: ProjPoint, q: ProjPoint) -> ProjPoint:
    """Complete projective addition (RCB Algorithm 7, a = 0): 12M + 2*b3."""
    M, A, S, B3 = _ops(curve)
    x1, y1, z1 = (mont.to_l16(a) for a in p)
    x2, y2, z2 = (mont.to_l16(a) for a in q)
    t0 = M(x1, x2)
    t1 = M(y1, y2)
    t2 = M(z1, z2)
    t3 = S(M(A(x1, y1), A(x2, y2)), A(t0, t1))     # X1Y2 + X2Y1
    t4 = S(M(A(y1, z1), A(y2, z2)), A(t1, t2))     # Y1Z2 + Y2Z1
    t5 = S(M(A(x1, z1), A(x2, z2)), A(t0, t2))     # X1Z2 + X2Z1
    t0 = A(A(t0, t0), t0)                          # 3 X1X2
    t2 = B3(t2)                                    # b3 Z1Z2
    z3 = A(t1, t2)
    t1 = S(t1, t2)
    t5 = B3(t5)
    x3 = S(M(t3, t1), M(t4, t5))
    y3 = A(M(t1, z3), M(t5, t0))
    z3 = A(M(z3, t4), M(t0, t3))
    return ProjPoint(*_words(x3, y3, z3))


def madd_plain(curve: CurveSpec, p: ProjPoint, q: AffinePoint) -> ProjPoint:
    """Complete mixed addition (RCB Algorithm 8, a = 0): 11M + 2*b3.
    Complete in p; q must be a genuine affine point."""
    M, A, S, B3 = _ops(curve)
    x1, y1, z1 = (mont.to_l16(a) for a in p)
    x2, y2 = (mont.to_l16(a) for a in q)
    t0 = M(x1, x2)
    t1 = M(y1, y2)
    t3 = S(M(A(x1, y1), A(x2, y2)), A(t0, t1))     # X1Y2 + X2Y1
    t4 = A(M(y2, z1), y1)                          # Y1 + Y2Z1
    t5 = A(M(x2, z1), x1)                          # X1 + X2Z1
    t0 = A(A(t0, t0), t0)                          # 3 X1X2
    t2 = B3(z1)                                    # b3 Z1
    z3 = A(t1, t2)
    t1 = S(t1, t2)
    t5 = B3(t5)
    x3 = S(M(t3, t1), M(t4, t5))
    y3 = A(M(t1, z3), M(t5, t0))
    z3 = A(M(z3, t4), M(t0, t3))
    return ProjPoint(*_words(x3, y3, z3))


def dbl_plain(curve: CurveSpec, p: ProjPoint) -> ProjPoint:
    """Complete doubling (RCB Algorithm 9, a = 0): 6M + 2S + 1*b3."""
    M, A, S, B3 = _ops(curve)
    x, y, z = (mont.to_l16(a) for a in p)
    t0 = M(y, y)
    z3 = A(A(t0, t0), A(t0, t0))
    z3 = A(z3, z3)                                 # 8 Y^2
    t1 = M(y, z)
    t2 = B3(M(z, z))                               # b3 Z^2
    x3 = M(t2, z3)
    y3 = A(t0, t2)
    z3 = M(t1, z3)
    t1 = A(t2, t2)
    t2 = A(t1, t2)                                 # 3 b3 Z^2
    t0 = S(t0, t2)
    y3 = A(x3, M(t0, y3))
    t1 = M(x, y)
    x3 = M(t0, t1)
    x3 = A(x3, x3)
    return ProjPoint(*_words(x3, y3, z3))


# ---------------------------------------------------------------------------
# Device dispatch
# ---------------------------------------------------------------------------

def add(curve: CurveSpec, p: ProjPoint, q: ProjPoint) -> ProjPoint:
    from ..ops import point_kernels
    return point_kernels.padd(curve, p, q)


def madd(curve: CurveSpec, p: ProjPoint, q: AffinePoint) -> ProjPoint:
    from ..ops import point_kernels
    return point_kernels.pmadd(curve, p, q)


def dbl(curve: CurveSpec, p: ProjPoint) -> ProjPoint:
    from ..ops import point_kernels
    return point_kernels.pdbl(curve, p)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def select(mask: torch.Tensor, p: ProjPoint, q: ProjPoint) -> ProjPoint:
    """Per-element select; ``mask`` has the batch shape."""
    m = mask.unsqueeze(0)
    return ProjPoint(*(torch.where(m, a, b) for a, b in zip(p, q)))


def neg(curve: CurveSpec, p: ProjPoint) -> ProjPoint:
    return ProjPoint(p.x, mont.neg(curve.fp, p.y), p.z)


def is_identity(curve: CurveSpec, p: ProjPoint) -> torch.Tensor:
    return (mont.canonical(curve.fp, p.z) == 0).all(dim=0)


def to_affine(curve: CurveSpec, p: ProjPoint) -> AffinePoint:
    """Normalise to canonical affine words; the identity maps to (0, 0)
    (the JAX package's convention)."""
    f = curve.fp
    zinv = mont.inv16(f, mont.to_l16(p.z))          # 0 -> 0
    x = mont.canonical16(f, mont.mul16(f, mont.to_l16(p.x), zinv))
    y = mont.canonical16(f, mont.mul16(f, mont.to_l16(p.y), zinv))
    return AffinePoint(mont.from_l16(x), mont.from_l16(y))


def eq(curve: CurveSpec, p: ProjPoint, q: ProjPoint) -> torch.Tensor:
    """Per-element equality of the points two projective triples stand for
    (the same answer as comparing their affine normalisations, without the
    inversions): X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1, and both or neither is the
    identity."""
    f = curve.fp
    M = lambda a, b: mont.canonical16(f, mont.mul16(f, mont.to_l16(a),
                                                    mont.to_l16(b)))
    same = ((M(p.x, q.z) == M(q.x, p.z)).all(0)
            & (M(p.y, q.z) == M(q.y, p.z)).all(0))
    return same & (is_identity(curve, p) == is_identity(curve, q))


def to_jacobian(curve: CurveSpec, p: ProjPoint) -> tuple:
    """Homogeneous (X : Y : Z) -> Jacobian (X Z, Y Z^2, Z), plain Montgomery
    arithmetic on the tensors' device (values in [0, 2p), or [0, p) where
    ``mont.canon``): the reference's result convention."""
    M = lambda a, b: mont.mul16(curve.fp, a, b)
    x, y, z = (mont.to_l16(a) for a in p)
    return mont.from_l16(M(x, z)), mont.from_l16(M(y, M(z, z))), p.z


def fold_sum(curve: CurveSpec, pts: ProjPoint) -> ProjPoint:
    """Sum a batch of points along the LAST axis to one point: ceil(log2 n)
    levels of pairwise complete adds (one ``add`` a level, so one padd
    launch a level on the card), an odd level padded with the identity."""
    n = pts.x.shape[-1]
    while n > 1:
        if n % 2:
            pad = identity(curve, tuple(pts.x.shape[1:-1]) + (1,),
                           pts.x.device)
            pts = ProjPoint(*(torch.cat([a, b], dim=-1)
                              for a, b in zip(pts, pad)))
            n += 1
        pts = add(curve, ProjPoint(*(a[..., 0:n:2] for a in pts)),
                  ProjPoint(*(a[..., 1:n:2] for a in pts)))
        n //= 2
    return ProjPoint(*(a[..., 0] for a in pts))


def scalar_mul_int(curve: CurveSpec, p: ProjPoint, k: int) -> ProjPoint:
    """k p for a Python integer k >= 0: double-and-add from the top bit,
    one ``dbl`` a bit and one ``add`` a set bit."""
    if k == 0:
        return identity(curve, tuple(p.x.shape[1:]), p.x.device)
    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = dbl(curve, acc)
        if bit == "1":
            acc = p if acc is None else add(curve, acc, p)
    return acc


def scalar_mul(curve: CurveSpec, p: ProjPoint, k_words: torch.Tensor,
               bits: int | None = None) -> ProjPoint:
    """k p for every point of the batch, k given as its canonical (8,)
    32-bit words (not Montgomery form), a tensor on any device.  A
    branch-free ladder from the low bit: one ``add``, one ``dbl`` and one
    ``select`` a bit over ``bits`` bits (default the scalar field's), so
    the work does not depend on k."""
    if bits is None:
        bits = curve.fr.bits
    if k_words.shape != (8,):
        raise ValueError("scalar_mul: k must be (8,) 32-bit words")
    shifts = torch.arange(32, dtype=torch.int64, device=k_words.device)
    kb = ((k_words.to(torch.int64).unsqueeze(1) >> shifts) & 1).reshape(-1)
    kb = kb[:bits].to(device=p.x.device, dtype=torch.bool)
    acc, base = identity(curve, tuple(p.x.shape[1:]), p.x.device), p
    for i in range(bits):
        acc = select(kb[i], add(curve, acc, base), acc)
        base = dbl(curve, base)
    return acc
