"""Pure-Python elliptic curve oracle (affine coordinates, big ints).

The port's own copy of ``panda_tpu/reference/curve_ref.py``.  Independent
of the kernels and of the complete-formula point code; it plays the role of
the arkworks CPU oracle in the reference CUDA library's tests.
"""

from __future__ import annotations

from ..curves.config import CurveSpec

INF = None  # affine identity


def is_on_curve(curve: CurveSpec, pt):
    if pt is INF:
        return True
    x, y = pt
    p = curve.fp.modulus
    return (y * y - x * x * x - curve.b) % p == 0


def ec_add(curve: CurveSpec, a, b):
    p = curve.fp.modulus
    if a is INF:
        return b
    if b is INF:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return INF
        # doubling
        lam = (3 * x1 * x1) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def ec_neg(curve: CurveSpec, a):
    if a is INF:
        return INF
    return (a[0], (-a[1]) % curve.fp.modulus)


# --- Jacobian fast path (internal) -----------------------------------------
# The affine ec_add above pays one modular inversion per operation; for the
# big sweeps (k >= 10 oracle MSMs) that dominates test wall-clock.  These
# helpers do the same math in Jacobian coordinates with a single inversion
# at the end.  Still fully independent of the device/native code paths.

_JINF = (0, 1, 0)


def _jadd(p: int, a, b):
    if a[2] == 0:
        return b
    if b[2] == 0:
        return a
    x1, y1, z1 = a
    x2, y2, z2 = b
    z1z1 = z1 * z1 % p
    z2z2 = z2 * z2 % p
    u1 = x1 * z2z2 % p
    u2 = x2 * z1z1 % p
    s1 = y1 * z2 * z2z2 % p
    s2 = y2 * z1 * z1z1 % p
    if u1 == u2:
        if (s1 + s2) % p == 0:
            return _JINF
        return _jdbl(p, a)
    h = (u2 - u1) % p
    i = 4 * h * h % p
    j = h * i % p
    r = 2 * (s2 - s1) % p
    v = u1 * i % p
    x3 = (r * r - j - 2 * v) % p
    y3 = (r * (v - x3) - 2 * s1 * j) % p
    z3 = ((z1 + z2) ** 2 - z1z1 - z2z2) % p * h % p
    return (x3, y3, z3)


def _jdbl(p: int, a):
    x1, y1, z1 = a
    if z1 == 0:
        return a
    aa = x1 * x1 % p
    b = y1 * y1 % p
    c = b * b % p
    d = 2 * ((x1 + b) ** 2 - aa - c) % p
    e = 3 * aa % p
    x3 = (e * e - 2 * d) % p
    y3 = (e * (d - x3) - 8 * c) % p
    z3 = 2 * y1 * z1 % p
    return (x3, y3, z3)


def _to_jac(pt):
    return _JINF if pt is INF else (pt[0], pt[1], 1)


def _from_jac(p: int, a):
    if a[2] == 0:
        return INF
    zi = pow(a[2], -1, p)
    zi2 = zi * zi % p
    return (a[0] * zi2 % p, a[1] * zi * zi2 % p)


def _jmul(p: int, a, k: int):
    acc = _JINF
    while k:
        if k & 1:
            acc = _jadd(p, acc, a)
        a = _jdbl(p, a)
        k >>= 1
    return acc


def ec_mul(curve: CurveSpec, a, k: int):
    k %= curve.fr.modulus
    p = curve.fp.modulus
    return _from_jac(p, _jmul(p, _to_jac(a), k))


def random_point(curve: CurveSpec, rng):
    """Random curve point as a random multiple of the generator."""
    g = (curve.gen_x, curve.gen_y)
    return ec_mul(curve, g, rng.randrange(1, curve.fr.modulus))


def msm_oracle(curve: CurveSpec, points, scalars):
    """Textbook MSM: sum scalar_i * P_i over affine int points."""
    p = curve.fp.modulus
    acc = _JINF
    for pt, s in zip(points, scalars):
        acc = _jadd(p, acc, _jmul(p, _to_jac(pt), s % curve.fr.modulus))
    return _from_jac(p, acc)
