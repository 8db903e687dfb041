"""The port's plain field arithmetic against the big-int oracle and the JAX
package (panda_tpu.fields.mont), on the same values.

The two packages use different Montgomery radices (2^256 here, 2^(15L)
there); ``from_jax_limbs``/``to_jax_limbs`` carry values between them.  All
comparisons are exact: field values equal after canonicalisation.  The
port's own copies of the field and curve parameters and error codes equal
the JAX package's.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from panda_tpu.curves import config as jcurves
from panda_tpu.fields import codec
from panda_tpu.fields import config as jfields
from panda_tpu.fields import mont as jmont
from panda_tpu.runtime import errors as jerrors
from panda_tpu_torch.curves import config as curves
from panda_tpu_torch.fields import config as fields
from panda_tpu_torch.fields import mont
from panda_tpu_torch.fields.config import BLS12_381_FR, BN254_FP, BN254_FR
from panda_tpu_torch.reference.field_ref import F
from panda_tpu_torch.runtime import errors

SPECS = [BN254_FP, BN254_FR]
JAX_SPECS = {s.name: s for s in jfields.ALL_FIELDS}


def _case(spec, seed, n=48):
    """Plain ints a, b: edge classes 0, 1, p-1 and random values."""
    rng = random.Random(seed)
    p = spec.modulus
    edge = [0, 1, p - 1, 2, p - 2]
    a = edge + [rng.randrange(p) for _ in range(n - len(edge))]
    b = [p - 1, 0, p - 1, p - 2, 1] + [rng.randrange(p)
                                       for _ in range(n - len(edge))]
    return a, b


def _port(spec, vals, lift=None):
    """Plain ints -> port Montgomery words; ``lift`` adds p to the chosen
    entries so that stored values near 2p are exercised."""
    R, p = mont.radix(spec), spec.modulus
    w = [v * R % p for v in vals]
    if lift is not None:
        w = [x + p if (i in lift and x + p < 2 * p) else x
             for i, x in enumerate(w)]
    return mont.words_tensor(mont.ints_to_words(spec, w))


def _plain(spec, words):
    """Port words (any representative) -> canonical plain ints."""
    p = spec.modulus
    rinv = pow(mont.radix(spec), -1, p)
    return [v * rinv % p for v in mont.words_to_ints(words)]


def _jax(spec, vals):
    """Plain ints -> the JAX package's Montgomery limbs for the port's
    ``spec``."""
    js = JAX_SPECS[spec.name]
    return jnp.asarray(codec.ints_to_limbs(js, [js.to_mont_int(v)
                                                for v in vals]))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_ops_match_oracle_and_jax(spec, op):
    a, b = _case(spec, 1 if op == "mul" else 2)
    lift = set(range(0, len(a), 3))                   # values in [p, 2p)
    A, B = _port(spec, a, lift), _port(spec, b, lift)
    got_w = {"mul": mont.mul, "add": mont.add, "sub": mont.sub}[op](spec, A, B)
    assert all(v < 2 * spec.modulus for v in mont.words_to_ints(got_w))
    got = _plain(spec, got_w)
    oracle = {"mul": F.__mul__, "add": F.__add__, "sub": F.__sub__}[op]
    want = [oracle(F.from_int(spec, x), F.from_int(spec, y)).to_int()
            for x, y in zip(a, b)]
    assert got == want
    jfn = {"mul": jmont.mont_mul, "add": jmont.add_mod,
           "sub": jmont.sub_mod}[op]
    js = JAX_SPECS[spec.name]
    jout = jax.jit(lambda x, y: jfn(js, x, y))(_jax(spec, a), _jax(spec, b))
    assert _plain(spec, mont.from_jax_limbs(spec, np.asarray(jout))) == want


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_canonical_neg_and_domain(spec):
    a, _ = _case(spec, 3)
    p = spec.modulus
    lift = set(range(len(a)))
    A = _port(spec, a, lift)
    R = mont.radix(spec)
    assert mont.words_to_ints(mont.canonical(spec, A)) == [v * R % p
                                                          for v in a]
    assert _plain(spec, mont.neg(spec, A)) == [(-v) % p for v in a]
    plain_w = mont.words_tensor(mont.ints_to_words(spec, a))
    assert mont.words_to_ints(mont.from_mont(spec, mont.to_mont(spec, plain_w))) == a
    inv = mont.batch_inverse(spec, A)
    assert _plain(spec, inv) == [pow(v, -1, p) if v else 0 for v in a]


def test_bls12_381_fr_chained_squarings_stay_exact():
    """Eight successive squarings of 128 BLS12-381 Fr values, half just
    below r, against Python big ints, word for word after every step.
    4r > 2^256 for this field, so a stored value near 2r times another
    passes R and loses its top: the port keeps this field's values in
    [0, r) (``mont.canon``), and the canonical words must equal the big
    ints at every step."""
    spec = BLS12_381_FR
    r = spec.modulus
    rinv = pow(mont.radix(spec), -1, r)
    rng = random.Random(381)
    want = [r - 1 - rng.randrange(1 << 128) for _ in range(64)] + \
        [rng.randrange(r) for _ in range(64)]
    x = mont.words_tensor(mont.ints_to_words(spec, want))
    bad, stored = [], []
    for _ in range(8):
        x = mont.mul(spec, x, x)
        want = [v * v * rinv % r for v in want]
        got = mont.words_to_ints(mont.canonical(spec, x))
        bad.append(sum(g != w for g, w in zip(got, want)))
        stored.append(mont.words_to_ints(x) == want)
    assert bad == [0] * 8, f"wrong of 128 at steps 1-8: {bad}"
    assert all(stored)


def _model(spec, op, a, b):
    """The exact stored words of mul, add and sub, as big ints: CIOS gives
    (a b + M p) / R with M = -a b p^-1 mod R; the [0, 2p) fields stop
    there and reduce add/sub by 2p, a canon field subtracts p once from
    the product and reduces add/sub by p."""
    p, R = spec.modulus, mont.radix(spec)
    m = p if mont.canon(spec) else 2 * p
    if op == "mul":
        t = (a * b + (-a * b * pow(p, -1, R)) % R * p) // R
        return t - p if mont.canon(spec) and t >= p else t
    return (a + b) % m if op == "add" else (a - b) % m


@pytest.mark.parametrize("spec", fields.ALL_FIELDS, ids=lambda s: s.name)
def test_stored_words_match_model(spec):
    """mul, add and sub on every field give the model's words exactly:
    unchanged for the five fields with 4p < R (inputs below 2p, edges 0,
    p - 1, p, 2p - 1), and the [0, p) invariant for BLS12-381 Fr (inputs
    below p, edges 0, 1, p - 1)."""
    p = spec.modulus
    hi = p if mont.canon(spec) else 2 * p
    rng = random.Random(spec.bits)
    edge = [0, 1, p - 1] + ([] if mont.canon(spec) else [p, 2 * p - 1])
    a = edge * len(edge) + [rng.randrange(hi) for _ in range(40)]
    b = [e for e in edge for _ in edge] + [hi - 1 - rng.randrange(1 << 64)
                                           for _ in range(40)]
    A, B = (mont.words_tensor(mont.ints_to_words(spec, v)) for v in (a, b))
    for op, fn in (("mul", mont.mul), ("add", mont.add), ("sub", mont.sub)):
        got = mont.words_to_ints(fn(spec, A, B))
        assert got == [_model(spec, op, x, y) for x, y in zip(a, b)], op
        assert all(v < hi for v in got)


def test_reduce_wire_takes_any_256_bit_value():
    spec = BN254_FP
    rng = random.Random(4)
    w = [0, spec.modulus, 2 * spec.modulus, (1 << 256) - 1] + \
        [rng.randrange(1 << 256) for _ in range(40)]
    got = mont.reduce_wire(spec, mont.words_tensor(mont.ints_to_words(spec, w)))
    assert mont.words_to_ints(got) == [v % spec.modulus for v in w]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_jax_limbs_round_trip(spec):
    a, _ = _case(spec, 5)
    j = np.asarray(_jax(spec, a))
    port = mont.from_jax_limbs(spec, j)
    assert _plain(spec, port) == a
    back = mont.to_jax_limbs(spec, port)
    np.testing.assert_array_equal(back, j)
    # a lazily reduced JAX value (+p) maps to the same canonical words
    js = JAX_SPECS[spec.name]
    assert mont.jax_limbs(spec) == js.n_limbs
    lazy = codec.ints_to_limbs(js, [js.to_mont_int(v) + spec.modulus
                                    for v in a])
    assert torch.equal(mont.from_jax_limbs(spec, lazy), port)


def test_bytes_words_round_trip():
    spec = BN254_FR
    rng = random.Random(6)
    vals = [rng.randrange(1 << 256) for _ in range(9)]
    blob = b"".join(v.to_bytes(32, "little") for v in vals)
    w = mont.bytes_to_words(spec, blob)
    assert mont.words_to_ints(w) == vals
    assert mont.words_to_bytes(spec, w) == blob
    with pytest.raises(ValueError):
        mont.bytes_to_words(spec, blob[:-1])


@pytest.mark.parametrize("i", range(len(fields.ALL_FIELDS)),
                         ids=[f.name for f in fields.ALL_FIELDS])
def test_field_copy_matches_jax(i):
    """Each copied field: the same name, modulus, generator, two-adicity,
    widths, wire radix, wire conversions and roots of unity."""
    mine, theirs = fields.ALL_FIELDS[i], jfields.ALL_FIELDS[i]
    assert mine is not theirs
    keys = ("name", "modulus", "generator", "two_adicity", "bits", "n_bytes",
            "wire_r")
    assert [getattr(mine, k) for k in keys] == [getattr(theirs, k)
                                                for k in keys]
    rng = random.Random(i)
    for v in [0, 1, mine.modulus - 1] + [rng.randrange(mine.modulus)
                                         for _ in range(5)]:
        assert mine.to_wire_int(v) == theirs.to_wire_int(v)
        assert mine.from_wire_int(v) == theirs.from_wire_int(v)
    if not mine.two_adicity:
        for spec in (mine, theirs):
            with pytest.raises(ValueError):
                spec.root_of_unity(1)
        return
    for log_n in range(0, mine.two_adicity + 1, 7):
        assert mine.root_of_unity(log_n) == theirs.root_of_unity(log_n)


def test_curve_and_error_copies_match_jax():
    assert list(curves.CURVES) == list(jcurves.CURVES)
    for name, c in curves.CURVES.items():
        j = jcurves.CURVES[name]
        assert (c.name, c.fp.name, c.fr.name, c.b, c.b3, c.gen_x, c.gen_y) \
            == (j.name, j.fp.name, j.fr.name, j.b, j.b3, j.gen_x, j.gen_y)
        p = c.fp.modulus
        assert (c.gen_y ** 2 - c.gen_x ** 3 - c.b) % p == 0
    assert [(e.name, int(e)) for e in errors.PandaError] == \
        [(e.name, int(e)) for e in jerrors.PandaError]
    e = errors.PandaRuntimeError(errors.PandaError.UNSUPPORTED_CURVE, "x")
    assert str(e) == str(jerrors.PandaRuntimeError(
        jerrors.PandaError.UNSUPPORTED_CURVE, "x"))
