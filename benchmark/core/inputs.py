"""Inputs made from the seed, handed the same to the program and the
reference.

A base set's 2^k rows are drawn from a pool of at most 1024 points (a_j G,
a_j = a_0 + j d, see ``reference/msm.py``): the card reads 2^k rows, the
reference needs only the pool's discrete logs.  A scalar vector is 2^k
independent full-range field elements, uniform on [0, r), drawn as their
wire (Montgomery) integers: the map to the plain scalars is a bijection, so
these are uniform too, and the reference works on the wire integers by
linearity.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np

from ..reference import curves
from ..reference import msm as msm_ref

def entropy(seed: int, *tags: int) -> list:
    """numpy seed material from any whole-number seed and integer tags."""
    return [int(seed) % (1 << 64), *tags]


def rows(fld: curves.Field, values) -> np.ndarray:
    """Wire integers -> (len, n_bytes / 4) little-endian uint32 rows."""
    raw = b"".join(v.to_bytes(fld.n_bytes, "little") for v in values)
    return np.frombuffer(raw, dtype="<u4").reshape(len(values), -1)


@dataclass
class BaseSet:
    """One cached base set: the pool points' discrete logs, which pool
    point each row holds, and the rows as wire bytes (x || y a point)."""
    logs: list
    pidx: np.ndarray
    blob: bytes | None


def base_set(curve: curves.Curve, log_n: int, seed: int, index: int,
             points: int) -> BaseSet:
    """Base set ``index``: 2^log_n rows from a pool of ``points`` points."""
    n = 1 << log_n
    pool = min(n, points)
    rng = random.Random(f"bases:{seed}:{curve.name}:{index}")
    r = curve.fr.modulus
    a0, d = rng.randrange(1, r), rng.randrange(1, r)
    pts = msm_ref.pool_points(curve, a0, d, pool)
    fp = curve.fp
    table = np.ascontiguousarray(np.concatenate(
        [rows(fp, [fp.to_wire(x) for x, _ in pts]),
         rows(fp, [fp.to_wire(y) for _, y in pts])], axis=1))
    pidx = np.random.default_rng(entropy(seed, 1, index, log_n)).integers(
        pool, size=n)
    return BaseSet([(a0 + j * d) % r for j in range(pool)], pidx,
                   table[pidx].tobytes())


def below(cand: np.ndarray, limit: np.ndarray) -> np.ndarray:
    """Which rows of ``cand`` (rows of little-endian 32-bit words) are
    below the integer whose words are ``limit``."""
    lt = np.zeros(len(cand), dtype=bool)
    eq = np.ones(len(cand), dtype=bool)
    for k in range(cand.shape[1] - 1, -1, -1):
        lt |= eq & (cand[:, k] < limit[k])
        eq &= cand[:, k] == limit[k]
    return lt


def uniform_words(fr: curves.Field, n: int, rng: np.random.Generator
                  ) -> np.ndarray:
    """n integers uniform on [0, r) as (n, n_bytes / 4) little-endian
    uint32 rows: the top word uniform on [0, t], t r's own top word, the
    others raw draws; a row at or above r (its top word t, one in about
    t rows) is drawn again, so what stays is uniform on [0, r)."""
    W = fr.n_bytes // 4
    limit = rows(fr, [fr.modulus])[0]
    out = rng.bit_generator.random_raw(n * W // 2).view("<u4").reshape(n, W)
    out[:, -1] = rng.integers(0, limit[-1], size=n, dtype=np.uint32,
                              endpoint=True)
    redo = np.flatnonzero(out[:, -1] == limit[-1])
    redo = redo[~below(out[redo], limit)]
    while len(redo):
        out[redo] = uniform_words(fr, len(redo), rng)
        redo = redo[~below(out[redo], limit)]
    return out


@dataclass
class ScalarVector:
    """A scalar vector's wire bytes, n rows of n_bytes each; ``words`` is
    their (n, n_bytes / 4) uint32 view, which the reference reads."""
    blob: bytes

    @property
    def words(self) -> np.ndarray:
        return np.frombuffer(self.blob, dtype="<u4").reshape(
            -1, msm_ref.SCALAR_WORDS)


def scalar_vector(curve: curves.Curve, log_n: int, seed: int,
                  index: int) -> ScalarVector:
    """Vector ``index``: 2^log_n full-range scalars, uniform on [0, r)."""
    rng = np.random.default_rng(entropy(seed, 2, index, log_n))
    return ScalarVector(uniform_words(curve.fr, 1 << log_n, rng).tobytes())
