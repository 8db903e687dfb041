"""The port's point helpers and device Horner (``curves/point.py``:
to_jacobian, fold_sum, scalar_mul_int, scalar_mul; ``ops/reduce.py``:
total_sum; ``ops/msm.py``: horner), plain versions on the CPU, against the
JAX package's functions on the same BN254 points, each under its own
``jax.jit``, and the big-integer curve oracle.  Points are compared after
affine normalisation, the Jacobian triple as plain integers.  The sizes
are the least that take every branch (an odd fold level, a set and a
clear bit): XLA compiles each unrolled point formula for seconds.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from panda_tpu.curves import point as jcp
from panda_tpu.curves.config import BN254 as JBN254
from panda_tpu.fields import codec
from panda_tpu.ops import msm as jmsm
from panda_tpu.ops import reduce as jred
from panda_tpu_torch.curves import point as cp
from panda_tpu_torch.curves.config import BN254
from panda_tpu_torch.curves.point import ProjPoint
from panda_tpu_torch.fields import mont
from panda_tpu_torch.ops import msm, point_kernels, reduce
from panda_tpu_torch.reference import curve_ref

FP, FR = BN254.fp, BN254.fr
JFP = JBN254.fp
P = FP.modulus
N = 3                        # odd: fold_sum pads a level with the identity
K_INT = 3                    # scalar_mul_int's small static scalar
C, WINDOWS = 3, 3            # horner on (L, 3, 2) window sums


def _affine(triples):
    out = []
    for x, y, z in triples:
        z %= P
        out.append(None if z == 0 else
                   (x * pow(z, -1, P) % P, y * pow(z, -1, P) % P))
    return out


def _plain_port(pt) -> list:
    """Port words -> plain ints (the Montgomery factor removed)."""
    rinv = pow(mont.radix(FP), -1, P)
    return [[v * rinv % P for v in mont.words_to_ints(a.reshape(8, -1))]
            for a in pt]


def _plain_jax(pt) -> list:
    rinv = pow(JFP.r, -1, P)
    return [[v * rinv % P for v in codec.limbs_to_ints(
        JFP, np.asarray(a).reshape(JFP.n_limbs, -1))] for a in pt]


def port_affine(pt):
    return _affine(zip(*_plain_port(pt)))


def jax_affine(pt):
    return _affine(zip(*_plain_jax(pt)))


def _points(n, seed):
    """n projective points as plain (X, Y, Z) ints with random Z, the
    identity at index 0, and their affine forms."""
    rng = random.Random(seed)
    aff = [None] + [curve_ref.random_point(BN254, rng) for _ in range(n - 1)]
    out = [(0, 1, 0)]
    for x, y in aff[1:]:
        z = rng.randrange(1, P)
        out.append((x * z % P, y * z % P, z))
    return out, aff


def _port(cols, shape):
    R = mont.radix(FP)
    return ProjPoint(*(mont.words_tensor(mont.ints_to_words(
        FP, [v * R % P for v in col])).reshape((8,) + shape) for col in cols))


def _jax(cols, shape):
    return jcp.ProjPoint(*(jnp.asarray(codec.ints_to_limbs(
        JFP, [JFP.to_mont_int(v) for v in col])).reshape(
            (JFP.n_limbs,) + shape) for col in cols))


def _sum(pts):
    acc = None
    for q in pts:
        acc = curve_ref.ec_add(BN254, acc, q)
    return acc


@pytest.fixture(scope="module")
def case():
    proj, aff = _points(N, 7)
    sproj, saff = _points(WINDOWS * 2, 9)
    cols, scols = list(zip(*proj)), list(zip(*sproj))
    # point j of the window sums is batch j // WINDOWS, window j % WINDOWS
    sums = ProjPoint(*(a.transpose(1, 2).contiguous() for a in _port(
        scols, (2, WINDOWS))))                       # (L, W, 2)
    jsums = jcp.ProjPoint(*(jnp.moveaxis(a, 2, 0) for a in _jax(
        scols, (2, WINDOWS))))                       # (W, L, 2)
    return {"p": _port(cols, (N,)), "jp": _jax(cols, (N,)), "aff": aff,
            "k": random.Random(8).randrange(FR.modulus), "sums": sums,
            "jsums": jsums,
            "window_aff": [[saff[b * WINDOWS + w] for w in range(WINDOWS)]
                           for b in range(2)]}


def test_to_jacobian_matches_jax(case):
    got = _plain_port(cp.to_jacobian(BN254, case["p"]))
    want = jax.jit(lambda p: jcp.to_jacobian(JBN254, p))(case["jp"])
    assert got == _plain_jax(want)
    for (x, y, z), a in zip(zip(*got), case["aff"]):
        if a is not None:
            assert (x * pow(z * z, -1, P) % P,
                    y * pow(z * z * z, -1, P) % P) == a


def test_fold_sum_matches_jax(case):
    got = cp.fold_sum(BN254, case["p"])
    assert got.x.shape == (8,)
    want = jax.jit(lambda p: jcp.fold_sum(JBN254, p))(case["jp"])
    assert port_affine(got) == jax_affine(want) == [_sum(case["aff"])]


def test_total_sum_matches_jax(case):
    got = reduce.total_sum(BN254, case["p"])
    want = jax.jit(lambda p: jred.total_sum(JBN254, p))(case["jp"])
    assert port_affine(got) == jax_affine(want) == [_sum(case["aff"])]


def test_scalar_mul_int_matches_jax(case):
    got = cp.scalar_mul_int(BN254, case["p"], K_INT)
    want = jax.jit(lambda p: jcp.scalar_mul_int(JBN254, p, K_INT))(
        case["jp"])
    assert port_affine(got) == jax_affine(want) == [
        None if a is None else curve_ref.ec_mul(BN254, a, K_INT)
        for a in case["aff"]]
    assert port_affine(cp.scalar_mul_int(BN254, case["p"], 0)) == [None] * N


def test_scalar_mul_matches_jax(case):
    k = case["k"]
    got = cp.scalar_mul(BN254, case["p"], mont.words_tensor(
        mont.ints_to_words(FR, [k])[:, 0]))
    want = jax.jit(lambda p, kl: jcp.scalar_mul(JBN254, p, kl))(
        case["jp"], jnp.asarray(codec.ints_to_limbs(JBN254.fr, [k])[:, 0]))
    assert port_affine(got) == jax_affine(want) == [
        None if a is None else curve_ref.ec_mul(BN254, a, k)
        for a in case["aff"]]


def test_horner_matches_jax(case):
    got = msm.horner(BN254, case["sums"], C)
    assert got.x.shape == (8, 2)
    want = []
    for ws in case["window_aff"]:
        acc = None
        for w, g in enumerate(ws):
            if g is not None:
                acc = curve_ref.ec_add(BN254, acc, curve_ref.ec_mul(
                    BN254, g, 1 << (C * w)))
        want.append(acc)
    jwant = jax.jit(lambda s: jmsm.horner(JBN254, s, C))(case["jsums"])
    assert port_affine(got) == jax_affine(jwant) == want
    with pytest.raises(ValueError):         # Horner's pdbl takes k >= 1
        point_kernels.pdbl(BN254, got, 0)
