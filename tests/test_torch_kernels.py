"""Each module that holds a kernel, through its plain version on the CPU,
against its JAX counterpart on the same inputs.

JAX sides that reach a Pallas kernel run as the JAX package's own tests run
them on the CPU: the plain references (``kernels="off"``), and the histogram
kernel in interpret mode.  Every comparison is exact: integers equal, points
equal after affine normalisation (projective representatives differ between
the packages by construction).
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
from panda_tpu.ops import hist_pallas
from panda_tpu.ops import msm as jmsm
from panda_tpu.ops import reduce as jred
from panda_tpu_torch.curves import point as cp
from panda_tpu_torch.curves.config import BN254
from panda_tpu_torch.curves.point import AffinePoint, ProjPoint
from panda_tpu_torch.fields import mont
from panda_tpu_torch.ops import hist, msm, reduce
from panda_tpu_torch.reference import curve_ref

FP, FR = BN254.fp, BN254.fr            # the port's specs
JFP, JFR = JBN254.fp, JBN254.fr        # the JAX package's
P = FP.modulus


def _affine(xs, ys, zs):
    """Projective Montgomery ints (any radix, any representative) ->
    affine ints; the Montgomery factor cancels in X/Z."""
    out = []
    for x, y, z in zip(xs, ys, zs):
        z %= P
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, P)
            out.append((x * zi % P, y * zi % P))
    return out


def port_affine(pt: ProjPoint):
    return _affine(*(mont.words_to_ints(a.reshape(8, -1)) for a in pt))


def jax_affine(pt):
    return _affine(*(codec.limbs_to_ints(JFP, np.asarray(a).reshape(
        JFP.n_limbs, -1)) for a in pt))


def _proj_ints(n, seed):
    """n projective points as plain (X, Y, Z) ints: random multiples of the
    generator scaled by random Z, with the identity at index 0."""
    rng = random.Random(seed)
    out = [(0, 1, 0)]
    for _ in range(n - 1):
        x, y = curve_ref.random_point(BN254, rng)
        z = rng.randrange(1, P)
        out.append((x * z % P, y * z % P, z))
    return out


def to_port(vals):
    R = mont.radix(FP)
    return mont.words_tensor(mont.ints_to_words(FP, [v * R % P for v in vals]))


def to_jax(vals):
    return jnp.asarray(codec.ints_to_limbs(JFP, [JFP.to_mont_int(v)
                                                 for v in vals]))


def _both(points):
    cols = list(zip(*points))
    return (ProjPoint(*(to_port(c) for c in cols)),
            jcp.ProjPoint(*(to_jax(c) for c in cols)))


def test_signed_digits_match_jax():
    n, c = 1024, 13
    rng = random.Random(8)
    r = FR.modulus
    vals = [0, 1, r - 1] + [rng.randrange(r) for _ in range(n - 3)]
    R = mont.radix(FR)
    port = mont.words_tensor(mont.ints_to_words(FR, [v * R % r for v in vals]))
    jsc = jnp.asarray(codec.ints_to_limbs(JFR, [JFR.to_mont_int(v)
                                                for v in vals]))
    mags, negs = msm.signed_digit_arrays(FR, port, c)
    jm, jn = jax.jit(lambda s: jmsm.signed_digit_arrays(
        JFR, s, c, kernels="off"))(jsc)
    np.testing.assert_array_equal(mags.numpy().astype(np.uint32),
                                  np.asarray(jm))
    np.testing.assert_array_equal(negs.numpy(), np.asarray(jn))
    # the recode is exact: sum_w (+-mag_w) 2^(c w) = s
    m, g = mags.numpy().astype(object), negs.numpy()
    for j in (0, 1, 2, 517):
        assert sum((-1 if g[w, j] else 1) * int(m[w, j]) << (c * w)
                   for w in range(m.shape[0])) == vals[j]


def test_hist_counts_match_pallas_interpret():
    rng = np.random.default_rng(5)
    W, n, D = 3, 4096, 1 << 11
    digits = rng.integers(0, D + 2, size=(W, n)).astype(np.int32)
    digits[:, :30] = 0
    got = hist.hist_counts(torch.from_numpy(digits), D)
    want = hist_pallas.hist_counts(jnp.asarray(digits.astype(np.uint32)), D,
                                   interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_point_ops_match_jax():
    pi = _proj_ints(8, 21)
    # q = p (doubling case), q = -p (cancelling case), then random points
    x, y, z = pi[2]
    qi = pi[:2] + [(x, (-y) % P, z)] + _proj_ints(5, 22)[1:] + [(0, 1, 0)]
    (p, jp), (q, jq) = _both(pi), _both(qi)
    got = cp.add(BN254, p, q)
    want = jax.jit(lambda a, b: jcp.add(JBN254, a, b))(jp, jq)
    assert port_affine(got) == jax_affine(want)
    assert port_affine(got)[2] is None
    aff = [curve_ref.random_point(BN254, random.Random(s)) for s in range(8)]
    xs, ys = zip(*aff)
    got = cp.madd(BN254, p, AffinePoint(to_port(xs), to_port(ys)))
    want = jax.jit(lambda a, b: jcp.madd(JBN254, a, b))(
        jp, jcp.AffinePoint(to_jax(xs), to_jax(ys)))
    assert port_affine(got) == jax_affine(want)
    got = cp.dbl(BN254, p)
    want = jax.jit(lambda a: jcp.dbl(JBN254, a))(jp)
    assert port_affine(got) == jax_affine(want)
    assert port_affine(got)[0] is None                  # 2 * identity


@pytest.fixture(scope="module")
def bucket_case():
    """Tiny phase-A case at D = 512 (the histogram path): W windows of n
    signed digits over random bases, through both packages once."""
    W, n, c, m = 2, 48, 10, 8
    D = 1 << (c - 1)
    rng = np.random.default_rng(11)
    mags = rng.integers(0, D + 1, size=(W, n))
    mags[:, :5] = 0
    mags[:, 5:9] = 7                                  # one long run
    negs = rng.integers(0, 2, size=(W, n)).astype(bool)
    pts = [curve_ref.random_point(BN254, random.Random(100 + i))
           for i in range(n)]
    px, py = (to_port(v) for v in zip(*pts))
    jpx, jpy = (to_jax(v) for v in zip(*pts))

    def jfn(a, b, d, s):
        bt = jmsm._bucket_tables(JBN254, a, b, d, c, m, signs=s,
                                 kernels="off")
        return bt, jred.weighted_window_sum(JBN254, bt)

    jbt, jws = jax.jit(jfn)(jpx, jpy, jnp.asarray(mags.astype(np.uint32)),
                            jnp.asarray(negs))
    bt = msm._bucket_tables(BN254, px, py,
                            torch.from_numpy(mags.astype(np.int32)),
                            torch.from_numpy(negs), c, m)
    return bt, jbt, jws, (mags, negs, pts, D)


def test_bucket_tables_match_jax(bucket_case):
    bt, jbt, _, (mags, negs, pts, D) = bucket_case
    got = port_affine(bt)
    assert got == jax_affine(jbt)
    # and the definition: B_b = sum of +-P_i over digits equal to b
    W = mags.shape[0]
    for w in range(W):
        for b in (1, 7, D):
            acc = None
            for i in np.nonzero(mags[w] == b)[0]:
                pt = pts[i]
                acc = curve_ref.ec_add(BN254, acc, curve_ref.ec_neg(
                    BN254, pt) if negs[w, i] else pt)
            assert got[w * D + b - 1] == acc


def test_weighted_window_sum_matches_jax(bucket_case):
    bt, _, jws, _ = bucket_case
    assert port_affine(reduce.weighted_window_sum(BN254, bt)) == \
        jax_affine(jws)
