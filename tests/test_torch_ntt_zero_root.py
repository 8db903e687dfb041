"""A zero root takes the stagewise engine under every ``PANDA_NTT_IMPL``,
in both packages (the byte API's ``ntt_v1`` at 2^10, BN254), and the NTT
kernels' plain versions for BLS12-381 Fr (``fmul``, the DFT pass and
``small_ntt_batch``) against the JAX package's Pallas kernels in interpret
mode, on the CPU.

The two packages use different Montgomery radices, so arrays go across
with ``mont.from_jax_limbs`` / ``to_jax_limbs`` (canonical on both sides).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from panda_tpu.fields import codec
from panda_tpu.fields import config as jfields
from panda_tpu.ops import ntt_fused as jntt_fused
from panda_tpu.ops import ntt_mxu as jntt_mxu
from panda_tpu.ops import ntt_pallas as jntt_pallas
from panda_tpu.ops import point_pallas
from panda_tpu.runtime import api as japi
from panda_tpu.runtime import manager as jmanager
from panda_tpu_torch import InitUnitType, PandaManager
from panda_tpu_torch.fields import mont
from panda_tpu_torch.fields.config import BLS12_381_FR
from panda_tpu_torch.ops import fmul, ntt_fused, ntt_pallas
from panda_tpu_torch.runtime import api
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


def _jax_limbs(vals):
    return jnp.asarray(codec.ints_to_limbs(JFR, [JFR.to_mont_int(v)
                                                 for v in vals]))


def _jax_plain(limbs) -> list:
    a = np.asarray(limbs)
    rinv = pow(JFR.r, -1, R)
    return [v * rinv % R for v in
            codec.limbs_to_ints(JFR, a.reshape(a.shape[0], -1))]


# Which engine each PANDA_NTT_IMPL runs at log_n 4, 9 and 10, as the JAX
# package's run_ntt: "stagewise", or the plan of "mxu" or "pallas".


@pytest.mark.parametrize("impl", ["auto", "mxu", "pallas"])
def test_zero_root_takes_the_stagewise_engine(impl, monkeypatch):
    """ntt_v1 with a zero root at 2^10 (BN254, words up to 2^256 - 1)
    gives the JAX package's bytes under ``impl`` and under jnp: both
    packages run the stagewise engine for it (the four-step and radix-2
    engines would compute another function)."""
    log_n, zero = 10, bytes(32)
    rng = random.Random(10)
    data = b"".join(rng.randrange(1 << 256).to_bytes(32, "little")
                    for _ in range(1 << log_n))
    gm = PandaManager.init_all(0, InitUnitType.NTT, device="cpu")
    jgm = jmanager.PandaManager.init_all(0, jmanager.InitUnitType.NTT)
    outs = {}
    for name in (impl, "jnp"):
        monkeypatch.setenv("PANDA_NTT_IMPL", name)
        outs[name] = api.ntt_v1(gm, data, log_n, zero)
        assert outs[name] == japi.ntt_v1(jgm, data, log_n, zero), name
    assert outs[impl] == outs["jnp"]


def test_bls12_381_fmul_matches_pallas_interpret():
    """fmul for BLS12-381 Fr (a, b < r, edges 0, 1, r - 1): the port's
    words below r, with and without canonical_out, equal to the JAX kernel
    in interpret mode."""
    n = 1024
    rng = random.Random(381)
    a = [0, 1, R - 1, R - 1] + [rng.randrange(R) for _ in range(n - 4)]
    b = [R - 1, R - 1, 1, R - 1] + [rng.randrange(R) for _ in range(n - 4)]
    A, B = _mont_words(FR, a), _mont_words(FR, b)
    got = fmul.fmul(FR, A, B)
    assert torch.equal(got, fmul.fmul(FR, A, B, canonical_out=True))
    assert mont.words_to_ints(got) == \
        [FR.to_wire_int(x * y % R) for x, y in zip(a, b)]
    jout = point_pallas.fmul(JFR, _jax_limbs(a), _jax_limbs(b),
                             interpret=True, canonical_out=True)
    assert torch.equal(mont.from_jax_limbs(FR, np.asarray(jout)), got)


def test_bls12_381_dft_matches_pallas_interpret():
    """The DFT pass for BLS12-381 Fr at K = 8, nb = 512 with the inverse's
    scale, on words up to 2^256 - 1: the port's output below r (the pass
    always takes its canonical subtraction for this field) and equal to
    the JAX fused pass in interpret mode, and to the definition."""
    log_k, nb = 3, 512
    K = 1 << log_k
    rng = random.Random(log_k)
    raw = [rng.randrange(1 << 256) for _ in range(K * nb)]
    raw[:3] = [(1 << 256) - 1, R, 2 * R - 1]
    w = pow(FR.root_of_unity(log_k), -1, R)
    scale = pow(1 << 11, -1, R)
    x = _words(FR, raw).reshape(8, K, nb)
    mat = ntt_fused.dft_matrix(FR, log_k, w, scale)
    got = ntt_fused.dft_apply_fused(FR, x, log_k, mat)
    assert torch.equal(got, ntt_fused.dft_apply_fused(FR, x, log_k, mat,
                                                      canonical_out=True))
    assert all(v < R for v in mont.words_to_ints(got.reshape(8, -1)))
    vals = [FR.from_wire_int(v) for v in raw]
    jmat = jnp.asarray(jntt_mxu.dft_matrix_grouped(JFR, log_k, w, scale))
    jx = _jax_limbs(vals).reshape(-1, K, nb)
    jout = jntt_fused.dft_apply_fused(JFR, jx, log_k, jmat, interpret=True)
    port = _plain(FR, got)
    assert port == _jax_plain(jout)
    v = np.array(vals, dtype=object).reshape(K, nb)
    for c in (0, 1, nb - 1):
        for k in (0, 1, K - 1):
            y = sum(int(v[j, c]) * pow(w, j * k, R) for j in range(K))
            assert port[k * nb + c] == y * scale % R


def test_bls12_381_small_ntt_matches_pallas_interpret():
    """small_ntt_batch for BLS12-381 Fr at K = 8, nb = 4: values below r in,
    below r out, equal to the JAX kernel in interpret mode (bit-reversed
    input); and with a pre table of B = 2 columns (batch 2), equal to the
    definition y[k, c] = sum_j w^(j k) pre[j, c // 2] x[j, c]."""
    log_k, nb, B = 3, 4, 2
    K = 1 << log_k
    rng = random.Random(381)
    vals = [R - 1] + [rng.randrange(R) for _ in range(K * nb - 1)]
    pre = [R - 1] + [rng.randrange(R) for _ in range(K * B - 1)]
    w = FR.root_of_unity(log_k)
    tw = ntt_pallas.stage_twiddle_rows(FR, log_k, w)
    x = _mont_words(FR, vals).reshape(8, K, nb)
    got = ntt_pallas.small_ntt_batch(FR, x, log_k, tw)
    jx = _jax_limbs(vals).reshape(-1, K, nb)[:, jntt_pallas._bitrev(log_k)]
    jtw = jnp.asarray(jntt_pallas.stage_twiddle_rows(JFR, log_k, w))
    jout = jntt_pallas.small_ntt_batch(JFR, jx, log_k, jtw, interpret=True)
    assert _plain(FR, got) == _jax_plain(jout)
    got = ntt_pallas.small_ntt_batch(
        FR, x, log_k, tw, pre_tw=_mont_words(FR, pre).reshape(8, K, B))
    assert all(v < R for v in mont.words_to_ints(got.reshape(8, -1)))
    port = _plain(FR, got)
    for c in range(nb):
        for k in range(K):
            y = sum(vals[j * nb + c] * pre[j * B + c // 2] * pow(w, j * k, R)
                    for j in range(K))
            assert port[k * nb + c] == y % R
