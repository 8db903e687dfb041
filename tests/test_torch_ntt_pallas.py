"""The radix-2 NTT engine (``PANDA_NTT_IMPL=pallas``): the port's plain
``small_ntt_batch``, its four-step recursion and the engine choice on the CPU,
against the JAX package (its Pallas kernel in interpret mode, its plan, its
byte API) and the big-integer NTT oracle.

The two packages use different Montgomery radices, so kernel outputs are
compared as canonical plain integers; byte-API outputs are canonical wire
bytes and are compared byte for byte.  Inputs include words >= r (any value
below 2^256 is a valid input word).  Three JAX interpret or compile calls in
all: one ``small_ntt_batch``, one ``fused_ntt`` (whose two passes are held
to the port's pass as well), one BLS12-377 byte-API NTT.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from panda_tpu.fields import codec
from panda_tpu.fields.config import BN254_FR as JFR
from panda_tpu.ops import ntt_pallas as jntt_pallas
from panda_tpu.runtime import api as japi
from panda_tpu.runtime import manager as jmanager
from panda_tpu_torch import InitUnitType, PandaManager
from panda_tpu_torch.curves.config import BLS12_377, BN254
from panda_tpu_torch.fields import mont
from panda_tpu_torch.ops import ntt as ntt_ops
from panda_tpu_torch.ops import ntt_pallas
from panda_tpu_torch.reference import ntt_ref
from panda_tpu_torch.runtime import api
from tests.jax_release import release_jax_programs  # noqa: F401

FR = BN254.fr
R = FR.modulus
RADIX = mont.radix(FR)


def _port_plain(words) -> list:
    """Port words (any representative) -> canonical plain ints."""
    rinv = pow(RADIX, -1, R)
    return [v * rinv % R for v in mont.words_to_ints(words.reshape(8, -1))]


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


def _wire(fr, vals) -> bytes:
    return b"".join(fr.to_wire_int(v).to_bytes(32, "little") for v in vals)


def _raw_words(fr, n, seed):
    """n random 256-bit input words, the first three >= r, as bytes and as
    the plain values they stand for."""
    r = fr.modulus
    rng = random.Random(seed)
    words = [rng.randrange(1 << 256) for _ in range(n)]
    words[:3] = [r, 2 * r + 7, (1 << 256) - 1]
    data = b"".join(v.to_bytes(32, "little") for v in words)
    return data, [fr.from_wire_int(v) for v in words]


def test_small_ntt_batch_matches_pallas_interpret():
    """K = 8, nb = 4 with a pre table of B = 2 columns (batch 2): the JAX
    kernel in interpret mode on the bit-reversed input and the table
    broadcast per element, the port's pass on natural order; and the
    definition y[k, c] = sum_j w^(j k) pre[j, c // 2] x[j, c]."""
    log_k, nb, B = 3, 4, 2
    K = 1 << log_k
    rng = random.Random(8)
    vals = [rng.randrange(R) for _ in range(K * nb)]
    pre = [rng.randrange(R) for _ in range(K * B)]
    w = FR.root_of_unity(log_k)
    br = jntt_pallas._bitrev(log_k)
    np.testing.assert_array_equal(ntt_pallas._bitrev(log_k), br)
    x = _port_words(vals, lift=set(range(0, K * nb, 3))).reshape(8, K, nb)
    got = ntt_pallas.small_ntt_batch(
        FR, x, log_k, ntt_pallas.stage_twiddle_rows(FR, log_k, w),
        pre_tw=_port_words(pre).reshape(8, K, B))
    assert all(v < 2 * R for v in mont.words_to_ints(got.reshape(8, -1)))
    per_elem = np.repeat(np.array(pre, dtype=object).reshape(K, B), nb // B,
                         axis=1)                                  # (K, nb)
    jx = _jax_limbs(vals).reshape(-1, K, nb)[:, br]
    jpre = _jax_limbs(per_elem.reshape(-1).tolist()).reshape(-1, K, nb)[:, br]
    jtw = jnp.asarray(jntt_pallas.stage_twiddle_rows(JFR, log_k, w))
    jout = jntt_pallas.small_ntt_batch(JFR, jx, log_k, jtw, pre_tw=jpre,
                                       interpret=True)
    port = _port_plain(got)
    assert port == _jax_plain(jout)
    for c in range(nb):
        for k in range(K):
            y = sum(vals[j * nb + c] * per_elem[j, c] * pow(w, j * k, R)
                    for j in range(K))
            assert port[k * nb + c] == y % R


@pytest.mark.parametrize("log_a,log_b,batch", [(3, 3, 1), (3, 2, 4),
                                               (2, 3, 2)])
def test_runs_layout_is_the_folded_transpose(log_a, log_b, batch):
    """The pass read as the four-step inner output view (W, B, A, batch)
    where it lies equals the old composition: the permute(...).contiguous()
    copy to rows j1 and columns (k2, batch), then the pass on that natural
    (W, A, B batch) tensor; with a T1 table and reduce_in on words >= r,
    and with the scale and the canonical store."""
    A, B = 1 << log_a, 1 << log_b
    rng = random.Random(A * B * batch)
    y = _port_words([rng.randrange(R) for _ in range(B * A * batch)],
                    lift=set(range(0, B * A * batch, 3))
                    ).reshape(8, B, A, batch)
    tw = ntt_pallas.stage_twiddle_rows(FR, log_a, FR.root_of_unity(log_a))
    t1t = _port_words([rng.randrange(R) for _ in range(A * B)]
                      ).reshape(8, A, B)
    scale = _port_words([pow(A, -1, R)]).reshape(8)
    z = y.permute(0, 2, 1, 3).contiguous().reshape(8, A, B * batch)
    for opts in ((t1t, None, True, False), (t1t, scale, False, True),
                 (None, None, False, False)):
        got = ntt_pallas.small_ntt_batch(FR, y, log_a, tw, *opts)
        assert got.shape == (8, A, B * batch)
        assert torch.equal(got, ntt_pallas.small_ntt_batch_plain(
            FR, z, log_a, tw, *opts))


def test_fused_ntt_matches_pallas_interpret(monkeypatch):
    """log_n 6, maxk 3 (one level of 8 x 8): the port's transform against
    JAX ``fused_ntt`` in interpret mode; and each of the JAX transform's
    two passes (the leaf, then the level with its T1 table) against the
    port's plain pass on the same values, un-bit-reversed."""
    log_n, maxk = 6, 3
    n = 1 << log_n
    rng = random.Random(6)
    vals = [rng.randrange(R) for _ in range(n)]
    calls = []
    real = jntt_pallas.small_ntt_batch

    def spy(spec, x, log_k, tw_rows, vb_in=None, pre_tw=None,
            interpret=False):
        out = real(spec, x, log_k, tw_rows, vb_in=vb_in, pre_tw=pre_tw,
                   interpret=interpret)
        calls.append((x, log_k, tw_rows, pre_tw, out))
        return out

    monkeypatch.setattr(jntt_pallas, "small_ntt_batch", spy)
    jout = jntt_pallas.fused_ntt(JFR, _jax_limbs(vals), log_n, maxk=maxk,
                                 interpret=True)
    x = _port_words(vals, lift=set(range(0, n, 4)))
    got = ntt_pallas.fused_ntt(FR, x, log_n, maxk=maxk)
    assert mont.words_to_ints(got) == [v * RADIX % R for v in _jax_plain(jout)]
    assert [c[3] is None for c in calls] == [True, False]
    for jx, log_k, jtw, jpre, jo in calls:
        K = 1 << log_k
        br = torch.from_numpy(ntt_pallas._bitrev(log_k)).long()
        nb = jx.shape[-1]
        px = _port_words(_jax_plain(jx)).reshape(8, K, nb)[:, br]
        tw = _port_words(_jax_plain(np.asarray(jtw)[0, :, :, 0]))
        pre = None if jpre is None else \
            _port_words(_jax_plain(jpre)).reshape(8, K, nb)[:, br]
        out = ntt_pallas.small_ntt_batch(FR, px.contiguous(), log_k, tw,
                                         pre_tw=pre)
        assert _port_plain(out) == _jax_plain(jo)


@pytest.mark.parametrize("curve,log_n,maxk", [
    (BN254, 3, 3), (BN254, 4, 3), (BN254, 5, 3), (BN254, 6, 3),
    (BN254, 7, 3), (BN254, 9, 3), (BN254, 11, 8), (BLS12_377, 9, 3),
    (BLS12_377, 11, 8)], ids=lambda v: getattr(v, "name", v))
def test_fused_ntt_matches_oracle(curve, log_n, maxk):
    """Forward and inverse against the big-integer oracle, bytes equal; at
    9 / 3 the second level's pre table serves 8 columns per table column."""
    fr = curve.fr
    data, vals = _raw_words(fr, 1 << log_n, log_n)
    x = mont.bytes_to_tensor(fr, data)
    w = fr.root_of_unity(log_n)
    fwd = ntt_pallas.fused_ntt(fr, x, log_n, maxk=maxk)
    assert mont.tensor_to_bytes(fwd) == _wire(fr, ntt_ref.ntt_oracle(fr, vals,
                                                                     w))
    inv = ntt_pallas.fused_ntt(fr, x, log_n, inverse=True, maxk=maxk)
    assert mont.tensor_to_bytes(inv) == _wire(fr, ntt_ref.intt_oracle(fr, vals,
                                                                      w))


def test_pass_shapes():
    """The passes the radix-2 engine launches at 2^20 and 2^22: the leaf
    (natural layout), then each level from the inside out, each reading the
    inner output view with its batch, the top one at batch 1."""
    assert ntt_pallas.pass_shapes(20) == [(6, 1 << 14, 0, False),
                                          (6, 1 << 14, 256, True),
                                          (8, 1 << 12, 1, True)]
    assert ntt_pallas.pass_shapes(22) == [(7, 1 << 15, 0, False),
                                          (7, 1 << 15, 256, True),
                                          (8, 1 << 14, 1, True)]
    assert ntt_pallas.pass_shapes(7, maxk=3) == [(4, 8, 0, False),
                                                 (3, 16, 1, True)]


@pytest.mark.parametrize("log_n,maxk", [(11, 8), (7, 3)])
def test_plan_matches_jax(log_n, maxk):
    """The JAX splits, and the same T1 and stage-twiddle values; the JAX
    package stores T1's rows bit-reversed, the port in natural order."""
    w = FR.root_of_unity(log_n)
    plan = ntt_pallas.fused_plan(FR, log_n, maxk=maxk)
    jplan = jntt_pallas.FusedNttPlan(JFR, log_n, w, maxk)
    assert [lv[:2] for lv in plan.levels] == [lv[:2] for lv in jplan.levels]
    assert plan.leaf[0] == jplan.leaf[0]
    assert plan.scale is None
    for (la, _, t1t, tw), (_, _, jt1t, jtw, jbr) in zip(plan.levels,
                                                        jplan.levels):
        br = torch.from_numpy(np.array(jbr)).long()
        assert _port_plain(t1t[:, br].contiguous()) == _jax_plain(jt1t)
        assert _port_plain(tw) == _jax_plain(np.asarray(jtw)[0, :, :, 0])
    assert _port_plain(plan.leaf[1]) == \
        _jax_plain(np.asarray(jplan.leaf[1])[0, :, :, 0])
    inv = ntt_pallas.fused_plan(FR, log_n, inverse=True, maxk=maxk)
    assert _port_plain(inv.scale) == [pow(1 << log_n, -1, R)]


@pytest.mark.parametrize("curve", [BN254, BLS12_377], ids=lambda c: c.name)
def test_pallas_engine_bytes(monkeypatch, curve):
    """PANDA_NTT_IMPL=pallas runs the radix-2 engine from 2^10 on, with the
    four-step engine's bytes and the oracle's; below 2^10 the stagewise
    engine runs (no plan; its twiddle tables), as in the JAX package."""
    fr = curve.fr
    gm = PandaManager.init_all(0, InitUnitType.NTT, curve=curve,
                               device="cpu")
    for log_n in (10, 11):
        data, vals = _raw_words(fr, 1 << log_n, 100 + log_n)
        w = fr.root_of_unity(log_n)
        out = {}
        for impl in ("auto", "pallas"):
            monkeypatch.setenv("PANDA_NTT_IMPL", impl)
            out[impl] = (api.ntt(gm, data, log_n), api.intt(gm, data, log_n))
        assert out["pallas"] == out["auto"]
        assert out["pallas"] == (_wire(fr, ntt_ref.ntt_oracle(fr, vals, w)),
                                 _wire(fr, ntt_ref.intt_oracle(fr, vals, w)))
        engines = {k[0] for k in gm.ntt_tables(log_n)._plans}
        assert engines == {"mxu", "pallas"}
    monkeypatch.setenv("PANDA_NTT_IMPL", "pallas")
    data, _ = _raw_words(fr, 1 << 9, 9)
    api.ntt(gm, data, 9)
    assert gm.ntt_tables(9)._plans == {}
    assert {k[0] for k in gm.ntt_tables(9)._tables} == {"bitrev", "w_pows"}


def test_engine_choice_errors(monkeypatch):
    """jnp (the stagewise engine) runs, from the variable or the argument,
    with the four-step engine's bytes; an unknown engine raises ValueError,
    from the variable or the argument."""
    x = mont.bytes_to_tensor(FR, _raw_words(FR, 1 << 10, 1)[0])
    tables = ntt_ops.make_tables(FR, 10)
    want = ntt_ops.run_ntt(FR, x, tables, impl="mxu")
    monkeypatch.setenv("PANDA_NTT_IMPL", "jnp")
    assert torch.equal(ntt_ops.run_ntt(FR, x, tables), want)
    monkeypatch.setenv("PANDA_NTT_IMPL", "radix4")
    with pytest.raises(ValueError):
        ntt_ops.run_ntt(FR, x, tables)
    with pytest.raises(ValueError):
        ntt_ops.run_ntt(FR, x, tables, impl="fft")
    assert torch.equal(ntt_ops.run_ntt(FR, x, tables, impl="jnp"), want)


def test_bls12_377_byte_api_matches_jax():
    """``ntt_bls12_377`` at 2^6, byte-equal to the JAX package's."""
    fr = BLS12_377.fr
    log_n = 6
    data, vals = _raw_words(fr, 1 << log_n, 377)
    gm = PandaManager.init_all(0, InitUnitType.NTT, curve="bls12_377",
                               device="cpu")
    jgm = jmanager.PandaManager.init_all(0, jmanager.InitUnitType.NTT,
                                         curve="bls12_377")
    out = api.ntt_bls12_377(gm, data, log_n)
    assert out == japi.ntt_bls12_377(jgm, data, log_n)
    assert out == _wire(fr, ntt_ref.ntt_oracle(fr, vals,
                                               fr.root_of_unity(log_n)))
