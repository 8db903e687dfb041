"""The NTT slice's kernel modules on the CPU against the JAX package: the
port's plain fmul and DFT against the JAX package's Pallas kernels in
interpret mode, and the four-step plan's splits and twiddle table against
the JAX plan.

The two packages use different Montgomery radices, so kernel outputs are
compared as canonical plain integers.  Inputs include words >= r (any value
below 2^256 is a valid input word).  The transform is tested in
``test_torch_ntt.py``, the byte API in ``test_torch_ntt_byte_api.py``.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from panda_tpu.fields import codec
from panda_tpu.fields.config import BN254_FR as JFR
from panda_tpu.ops import ntt_fused as jntt_fused
from panda_tpu.ops import ntt_mxu as jntt_mxu
from panda_tpu.ops import ntt_pallas as jntt_pallas
from panda_tpu.ops import point_pallas
from panda_tpu_torch.curves.config import BN254
from panda_tpu_torch.fields import mont
from panda_tpu_torch.ops import fmul, ntt_fused, ntt_mxu
from tests.jax_release import release_jax_programs  # noqa: F401

FR = BN254.fr
R = FR.modulus
RADIX = mont.radix(FR)


def _port_plain(words) -> list:
    """Port words (any representative) -> canonical plain ints."""
    rinv = pow(RADIX, -1, R)
    return [v * rinv % R for v in mont.words_to_ints(words)]


def _jax_plain(limbs) -> list:
    """JAX limbs (any representative below its R) -> canonical plain ints."""
    a = np.asarray(limbs)
    rinv = pow(JFR.r, -1, R)
    return [v * rinv % R for v in
            codec.limbs_to_ints(JFR, a.reshape(a.shape[0], -1))]


def _port_words(vals, lift=()):
    """Plain ints -> port Montgomery words; entries in ``lift`` get + r."""
    w = [v * RADIX % R + (R if i in lift else 0) for i, v in enumerate(vals)]
    return mont.words_tensor(mont.ints_to_words(FR, w))


def _jax_limbs(vals):
    return jnp.asarray(codec.ints_to_limbs(JFR, [JFR.to_mont_int(v)
                                                 for v in vals]))


def test_fmul_matches_pallas_interpret():
    n = 1024
    rng = random.Random(3)
    a = [0, 1, R - 1] + [rng.randrange(R) for _ in range(n - 3)]
    b = [R - 1, R - 1, 1] + [rng.randrange(R) for _ in range(n - 3)]
    want = [x * y % R for x, y in zip(a, b)]
    A = _port_words(a, lift=set(range(0, n, 3)))          # values in [0, 2r)
    B = _port_words(b)
    got = fmul.fmul(FR, A, B)
    assert all(v < 2 * R for v in mont.words_to_ints(got))
    assert _port_plain(got) == want
    canon = fmul.fmul(FR, A, B, canonical_out=True)
    assert mont.words_to_ints(canon) == [v * RADIX % R for v in want]
    jout = point_pallas.fmul(JFR, _jax_limbs(a), _jax_limbs(b),
                             interpret=True, canonical_out=True)
    assert torch.equal(mont.from_jax_limbs(FR, np.asarray(jout)), canon)


@pytest.mark.parametrize("log_k,inverse", [(3, False), (3, True),
                                           (5, False), (5, True)])
def test_dft_matches_pallas_interpret(log_k, inverse):
    """The port's plain DFT pass and the JAX package's fused Pallas pass
    (interpret mode), with scale 1 and with an n^-1 scale."""
    K, nb = 1 << log_k, 512
    rng = random.Random(log_k)
    vals = [rng.randrange(R) for _ in range(K * nb)]
    w = FR.root_of_unity(log_k)
    scale = pow(1 << 11, -1, R) if inverse else 1
    if inverse:
        w = pow(w, -1, R)
    x = _port_words(vals, lift=set(range(0, K * nb, 5))).reshape(8, K, nb)
    mat = ntt_fused.dft_matrix(FR, log_k, w, scale)
    got = ntt_fused.dft_apply_fused(FR, x, log_k, mat, canonical_out=inverse)
    limit = R if inverse else 2 * R
    assert all(v < limit for v in mont.words_to_ints(got.reshape(8, -1)))
    jmat = jnp.asarray(jntt_mxu.dft_matrix_grouped(JFR, log_k, w, scale))
    jx = _jax_limbs(vals).reshape(-1, K, nb)
    jout = jntt_fused.dft_apply_fused(JFR, jx, log_k, jmat, interpret=True)
    port = _port_plain(got.reshape(8, -1))
    assert port == _jax_plain(jout)
    # and the definition, at a few columns
    v = np.array(vals, dtype=object).reshape(K, nb)
    for c in (0, 1, nb - 1):
        for k in (0, 1, K - 1):
            y = sum(int(v[j, c]) * pow(w, j * k, R) for j in range(K))
            assert port[k * nb + c] == y * scale % R


def test_plan_matches_jax():
    """The same four-step splits as the JAX package's fused plan (maxk 5),
    and the same inter-level twiddle values in the same (L, A, B) layout."""
    log_n = 11
    plan = ntt_mxu.mxu_plan(FR, log_n)
    jplan = jntt_mxu.mxu_plan(JFR, log_n, maxk=5, fused=True)
    assert [lv[:2] for lv in plan.levels] == [lv[:2] for lv in jplan.levels]
    assert plan.leaf[0] == jplan.leaf[0]
    w = FR.root_of_unity(log_n)
    t1 = ntt_mxu.t1_table(FR, w, 5, 6)                       # (8, A, B)
    jt1 = np.swapaxes(np.asarray(jntt_pallas.FusedNttPlan._t1_table(
        JFR, w, 5, 6)), 1, 2)                                # (L, A, B)
    assert mont.words_to_ints(t1.reshape(8, -1)) == \
        [v * RADIX % R for v in _jax_plain(jt1)]
