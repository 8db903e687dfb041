"""The MSM's plain reference: sum_i s_i P_i over every row.

Every base point is a known multiple of the generator: pool point j of a
base set is a_j G with a_j = a_0 + j d (mod r), made by affine additions
(``pool_points``), and row i of a base set holds pool point ``pidx[i]``.
The scalars come as their wire integers w_i = s_i R mod r (Montgomery
form).  So, in the group of prime order r,

    sum_i s_i P_i = (R^-1 sum_j a_j agg_j mod r) G,   agg_j = sum_{pidx_i = j} w_i

exactly: the per-point sums of the wire integers (``aggregate``, exact word
by word in float64), one product and one scalar multiplication give the
whole MSM.  ``textbook`` is the plain double-and-add sum over every row,
which the tests hold it to at small n.
"""

from __future__ import annotations

import numpy as np

from . import curves

# 32-bit words of a scalar on the wire (32 bytes for every scalar field
# here).
SCALAR_WORDS = 8

# The control cuts every scalar's wire integer to its low 240 bits: an
# ingest that drops the top window of c = 16 bits of what it reads.
CONTROL_KEEP_BITS = 240


def pool_points(curve: curves.Curve, a0: int, d: int, count: int) -> list:
    """[a_j G for j < count], a_j = a0 + j d mod r: one scalar
    multiplication for the first, one for the step, then additions."""
    g = curve.gen
    first, step = curves.mul(curve, g, a0), curves.mul(curve, g, d)
    pts = [first]
    for _ in range(count - 1):
        pts.append(curves.add(curve, pts[-1], step))
    if any(p is None for p in pts):
        raise ValueError("pool_points: the identity is not a base point")
    return pts


def aggregate(pidx: np.ndarray, words: np.ndarray, r: int,
              points: int) -> list:
    """agg[j] = sum, mod r, of the scalars (``words``: their (n, 8) 32-bit
    words) of the rows that hold pool point j.  One float64 bincount a
    word, exact while a point's draws times 2^32 stay below 2^53."""
    if np.bincount(pidx, minlength=points).max() >= 1 << 21:
        raise ValueError("aggregate: too many draws of one point")
    sums = [np.bincount(pidx, weights=words[:, k].astype(np.float64),
                        minlength=points) for k in range(words.shape[1])]
    return [sum(int(col[j]) << (32 * k) for k, col in enumerate(sums)) % r
            for j in range(points)]


def result(curve: curves.Curve, logs: list, agg: list):
    """The MSM's affine result from the pool points' discrete logs and
    the per-point sums of the wire integers."""
    fr = curve.fr
    k = sum(a * s for a, s in zip(logs, agg)) % fr.modulus
    return curves.mul(curve, curve.gen, fr.from_wire(k))


def expected_blob(curve: curves.Curve, logs: list, pidx,
                  words: np.ndarray) -> bytes:
    """The blob the MSM over these rows must return."""
    agg = aggregate(pidx, words, curve.fr.modulus, len(logs))
    return curves.blob(curve, result(curve, logs, agg))


def control_blob(curve: curves.Curve, logs: list, pidx,
                 words: np.ndarray) -> bytes:
    """The control: the same MSM with every scalar's wire integer cut to
    its low ``CONTROL_KEEP_BITS`` bits."""
    cut = words.copy()
    full, part = divmod(CONTROL_KEEP_BITS, 32)
    cut[:, full] &= (1 << part) - 1
    cut[:, full + (part > 0):] = 0
    return expected_blob(curve, logs, pidx, cut)


def textbook(curve: curves.Curve, points: list, scalars: list):
    """sum_i s_i P_i by double-and-add over every row (plain ints)."""
    p = curve.fp.modulus
    acc = curves.JINF
    for pt, s in zip(points, scalars):
        q = curves.mul(curve, pt, s)
        if q is not None:
            acc = curves.jadd(p, acc, (q[0], q[1], 1))
    return curves.to_affine(p, acc)
