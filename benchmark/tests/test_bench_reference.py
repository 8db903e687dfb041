"""The plain reference at small sizes against known values and against the
textbook sums it stands in for."""

import numpy as np
import pytest

from benchmark.core import inputs
from benchmark.reference import curves, msm


@pytest.mark.parametrize("curve", [curves.BN254, curves.BLS12_377,
                                   curves.BLS12_381], ids=lambda c: c.name)
def test_generator_and_order(curve):
    assert curves.on_curve(curve, curve.gen)
    assert curves.mul(curve, curve.gen, curve.fr.modulus) is None
    two = curves.mul(curve, curve.gen, 2)
    assert two == curves.add(curve, curve.gen, curve.gen)
    assert curves.on_curve(curve, two)


def test_blob_format():
    fp = curves.BN254.fp
    blob = curves.blob(curves.BN254, (1, 2))
    assert len(blob) == 96
    assert int.from_bytes(blob[:32], "little") == fp.to_wire(1)
    assert int.from_bytes(blob[32:64], "little") == fp.to_wire(2)
    assert int.from_bytes(blob[64:], "little") == fp.to_wire(1)
    ident = curves.blob(curves.BLS12_377, None)
    assert len(ident) == 144
    assert int.from_bytes(ident[48:96], "little") == \
        curves.BLS12_377.fp.to_wire(1)
    assert ident[:48] == ident[96:] == bytes(48)


def plain_scalars(curve, vec):
    """The plain scalars of a vector, one by one from its wire rows."""
    fr = curve.fr
    return [fr.from_wire(int.from_bytes(vec.blob[32 * i:32 * i + 32],
                                        "little"))
            for i in range(len(vec.blob) // 32)]


@pytest.mark.parametrize("curve", [curves.BN254, curves.BLS12_377],
                         ids=lambda c: c.name)
def test_msm_oracle_equals_the_textbook_sum(curve):
    log_n, seed = 5, 2**31 + 77
    base = inputs.base_set(curve, log_n, seed, 0, points=8)
    vec = inputs.scalar_vector(curve, log_n, seed, 0)
    pts = msm.pool_points(curve, base.logs[0],
                          (base.logs[1] - base.logs[0]) % curve.fr.modulus, 8)
    assert all(curves.on_curve(curve, p) for p in pts)
    assert pts[3] == curves.mul(curve, curve.gen, base.logs[3])
    rows = [pts[j] for j in base.pidx]
    want = curves.blob(curve, msm.textbook(curve, rows,
                                           plain_scalars(curve, vec)))
    got = msm.expected_blob(curve, base.logs, base.pidx, vec.words)
    assert got == want
    assert msm.control_blob(curve, base.logs, base.pidx, vec.words) != want


def test_msm_control_is_the_sum_of_the_cut_scalars():
    """The control is the textbook sum over the scalars whose wire
    integers keep only their low 240 bits."""
    curve, log_n = curves.BN254, 4
    base = inputs.base_set(curve, log_n, 9, 0, points=4)
    vec = inputs.scalar_vector(curve, log_n, 9, 1)
    fr = curve.fr
    cut = [fr.from_wire(int.from_bytes(vec.blob[32 * i:32 * i + 32],
                                       "little") % (1 << 240))
           for i in range(1 << log_n)]
    rows = [curves.mul(curve, curve.gen, base.logs[j]) for j in base.pidx]
    assert msm.control_blob(curve, base.logs, base.pidx, vec.words) == \
        curves.blob(curve, msm.textbook(curve, rows, cut))


def test_msm_inputs_on_the_wire():
    """The bytes the program reads are the wire form of the reference's
    rows: bases x || y per point, scalars in Montgomery form below r."""
    curve = curves.BN254
    base = inputs.base_set(curve, 4, 5, 1, points=4)
    vec = inputs.scalar_vector(curve, 4, 5, 3)
    fp, fr = curve.fp, curve.fr
    i = 7
    pt = curves.mul(curve, curve.gen, base.logs[base.pidx[i]])
    row = base.blob[64 * i:64 * (i + 1)]
    assert fp.from_wire(int.from_bytes(row[:32], "little")) == pt[0]
    assert fp.from_wire(int.from_bytes(row[32:], "little")) == pt[1]
    assert len(vec.blob) == 16 * 32 and vec.words.shape == (16, 8)
    w = int.from_bytes(vec.blob[32 * i:32 * i + 32], "little")
    assert w == sum(int(vec.words[i, k]) << (32 * k) for k in range(8))
    assert w < fr.modulus


@pytest.mark.parametrize("curve", [curves.BN254, curves.BLS12_377,
                                   curves.BLS12_381], ids=lambda c: c.name)
def test_scalars_are_full_range_and_distinct(curve):
    """Every scalar drawn on its own, uniform on [0, r): all below r, no
    two alike, and the top word spread over its whole range."""
    fr = curve.fr
    n = 1 << 14
    words = inputs.uniform_words(fr, n, np.random.default_rng(5))
    ints = [sum(int(row[k]) << (32 * k) for k in range(8)) for row in words]
    assert max(ints) < fr.modulus
    assert len(set(ints)) == n
    top = words[:, 7].astype(np.float64) / (fr.modulus >> 224)
    counts = np.histogram(top, bins=8, range=(0.0, 1.0))[0]
    assert counts.min() > 0.8 * n / 8 and counts.max() < 1.2 * n / 8
    assert inputs.below(words, inputs.rows(fr, [fr.modulus])[0]).all()


def test_scalars_at_r_top_word_are_drawn_again():
    """A field whose top word is often r's own: every row stays below r,
    and rows with r's top word that are below r are kept (half of them
    here: r's lower words are 2^223)."""
    fr = curves.Field("tiny", (5 << 224) + (1 << 223))
    words = inputs.uniform_words(fr, 4096, np.random.default_rng(3))
    ints = [sum(int(row[k]) << (32 * k) for k in range(8)) for row in words]
    assert max(ints) < fr.modulus
    assert sorted(set(words[:, 7].tolist())) == [0, 1, 2, 3, 4, 5]
    assert any(x < fr.modulus for x in ints if x >> 224 == 5)
    again = inputs.uniform_words(fr, 4096, np.random.default_rng(3))
    assert (words == again).all()


def test_below_compares_whole_integers():
    limit = np.array([5, 0, 7], dtype="<u4")
    cand = np.array([[4, 0, 7], [5, 0, 7], [6, 0, 7], [0, 1, 6],
                     [0, 0, 8], [9, 9, 6]], dtype="<u4")
    assert inputs.below(cand, limit).tolist() == [True, False, False, True,
                                                  False, True]


def test_inputs_follow_the_seed():
    curve = curves.BN254
    a = inputs.base_set(curve, 6, 2**33 + 1, 0, points=16)
    b = inputs.base_set(curve, 6, 2**33 + 1, 0, points=16)
    c = inputs.base_set(curve, 6, 2**33 + 2, 0, points=16)
    assert a.blob == b.blob and a.logs == b.logs
    assert a.blob != c.blob
    assert (np.bincount(a.pidx, minlength=16) > 0).sum() > 8
    assert inputs.scalar_vector(curve, 6, 2**33 + 1, 0).blob == \
        inputs.scalar_vector(curve, 6, 2**33 + 1, 0).blob
    assert inputs.scalar_vector(curve, 6, 2**33 + 1, 0).blob != \
        inputs.scalar_vector(curve, 6, 2**33 + 1, 1).blob
