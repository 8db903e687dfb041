"""The stagewise NTT engine on the CPU, against the JAX package and the
big-integer oracle.

* The array-level ``ntt`` / ``intt`` against JAX ``ops.ntt.ntt_jitted``
  (mode "off", its XLA stages) for BLS12-381 Fr, and against the JAX
  package's pure-Python ``ntt_oracle`` for BN254 Fr and BLS12-377 Fr, with
  a batch dimension.
* ``run_ntt``'s dispatch for each ``PANDA_NTT_IMPL``: which engine runs at
  log_n 4, 9 and 10, and the same bytes from every engine.

The two packages use different Montgomery radices, so arrays go across
with ``mont.from_jax_limbs`` / ``to_jax_limbs`` (canonical on both sides).
Two JAX compiles (``ntt_jitted`` forward and inverse) in all.  A zero
root and the BLS12-381 Fr kernels are tested in
``test_torch_ntt_zero_root.py``.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from panda_tpu.fields import config as jfields
from panda_tpu.ops import ntt as jntt
from panda_tpu.reference import ntt_ref as jntt_ref
from panda_tpu_torch.fields import mont
from panda_tpu_torch.fields.config import (BLS12_377_FR, BLS12_381_FR,
                                           BN254_FR)
from panda_tpu_torch.ops import ntt as ntt_ops
from tests.jax_release import release_jax_programs  # noqa: F401

FR = BLS12_381_FR
R = FR.modulus
JFR = jfields.BLS12_381_FR


def _words(spec, vals) -> torch.Tensor:
    return mont.words_tensor(mont.ints_to_words(spec, vals))


def _mont_words(spec, vals) -> torch.Tensor:
    """Plain ints -> canonical port Montgomery words."""
    return _words(spec, [spec.to_wire_int(v) for v in vals])


def _plain(spec, words) -> list:
    """Port words (any representative) -> canonical plain ints."""
    return [spec.from_wire_int(v)
            for v in mont.words_to_ints(words.reshape(words.shape[0], -1))]


@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
def test_stagewise_matches_jax_ntt_jitted_bls12_381(inverse):
    """2^6 BLS12-381 Fr values (the first two r - 1 and r - 2), through the
    port's ``ntt`` / ``intt`` and JAX ``ntt_jitted(spec, 6, inverse,
    "off")``: the same canonical words, and the oracle's values."""
    log_n, n = 6, 1 << 6
    rng = random.Random(6 + inverse)
    vals = [R - 1, R - 2] + [rng.randrange(R) for _ in range(n - 2)]
    x = _mont_words(FR, vals)
    tables = ntt_ops.make_tables(FR, log_n)
    got = (ntt_ops.intt if inverse else ntt_ops.ntt)(FR, x, tables)
    jt = jntt.make_tables(JFR, log_n)
    fn = jntt.ntt_jitted(JFR, log_n, inverse, "off")
    jout = fn(jnp.asarray(mont.to_jax_limbs(FR, x)), jt.bitrev,
              jt.w_inv_pows if inverse else jt.w_pows, jnp.asarray(jt.n_inv))
    assert torch.equal(got, mont.from_jax_limbs(FR, np.asarray(jout)))
    w = FR.root_of_unity(log_n)
    oracle = jntt_ref.intt_oracle if inverse else jntt_ref.ntt_oracle
    assert _plain(FR, got) == oracle(JFR, vals, w)


@pytest.mark.parametrize("spec", [BN254_FR, BLS12_377_FR],
                         ids=lambda s: s.name)
def test_stagewise_matches_oracle_with_batch(spec):
    """(W, 3, 2^6) words, rows of values below r and of any word below
    2^256: each row's ``ntt`` / ``intt`` equals the JAX package's
    ``ntt_oracle`` / ``intt_oracle``, canonical, and the roundtrip gives
    the canonical input back."""
    log_n, n, p = 6, 1 << 6, spec.modulus
    rng = random.Random(spec.bits)
    rows = [[rng.randrange(1 << 256) for _ in range(n)] for _ in range(3)]
    rows[0][:2] = [(1 << 256) - 1, p]
    x = torch.stack([_words(spec, r) for r in rows], dim=1)    # (8, 3, n)
    tables = ntt_ops.make_tables(spec, log_n)
    fwd, inv = ntt_ops.ntt(spec, x, tables), ntt_ops.intt(spec, x, tables)
    js = {s.name: s for s in jfields.ALL_FIELDS}[spec.name]
    w = spec.root_of_unity(log_n)
    for i, row in enumerate(rows):
        vals = [spec.from_wire_int(v) for v in row]
        for out, oracle in ((fwd, jntt_ref.ntt_oracle),
                            (inv, jntt_ref.intt_oracle)):
            assert mont.words_to_ints(out[:, i]) == \
                [spec.to_wire_int(v) for v in oracle(js, vals, w)]
    assert torch.equal(ntt_ops.intt(spec, fwd, tables),
                       mont.reduce_wire(spec, x))


# Which engine each PANDA_NTT_IMPL runs at log_n 4, 9 and 10, as the JAX
# package's run_ntt: "stagewise", or the plan of "mxu" or "pallas".
ENGINE = {("auto", False): "stagewise", ("auto", True): "mxu",
          ("mxu", False): "mxu", ("mxu", True): "mxu",
          ("pallas", False): "stagewise", ("pallas", True): "pallas",
          ("jnp", False): "stagewise", ("jnp", True): "stagewise"}


@pytest.mark.parametrize("log_n", [4, 9, 10])
def test_run_ntt_dispatch(monkeypatch, log_n):
    """Each PANDA_NTT_IMPL runs the JAX package's engine for log_n (a
    fresh table set each, then which caches it filled), forward and
    inverse, and every engine gives the same bytes (BLS12-381 Fr, words
    up to 2^256 - 1)."""
    n = 1 << log_n
    rng = random.Random(log_n)
    raw = [rng.randrange(1 << 256) for _ in range(n)]
    raw[:2] = [(1 << 256) - 1, R]
    x = _words(FR, raw)
    outs = {}
    for impl in ntt_ops.IMPLS:
        monkeypatch.setenv("PANDA_NTT_IMPL", impl)
        tables = ntt_ops.make_tables(FR, log_n)
        outs[impl] = [ntt_ops.run_ntt(FR, x, tables, inverse)
                      for inverse in (False, True)]
        ran = {k[0] for k in tables._plans} or \
            {"stagewise" for k in tables._tables if k[0] == "bitrev"}
        assert ran == {ENGINE[impl, log_n >= ntt_ops.FUSED_MIN_LOG_N]}, impl
    for impl in ntt_ops.IMPLS:
        for a, b in zip(outs[impl], outs["mxu"]):
            assert torch.equal(a, b), impl
    w = FR.root_of_unity(log_n)
    vals = [FR.from_wire_int(v) for v in raw]
    assert _plain(FR, outs["jnp"][0]) == jntt_ref.ntt_oracle(JFR, vals, w)
