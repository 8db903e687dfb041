"""The NTT slice: the port's plain fmul, DFT, four-step transform and byte
API on the CPU, against the JAX package (its Pallas kernels in interpret
mode, its byte API) and the big-integer NTT oracle.

The two packages use different Montgomery radices, so kernel outputs are
compared as canonical plain integers; byte-API outputs are canonical wire
bytes and are compared byte for byte.  Inputs include words >= r (any value
below 2^256 is a valid input word).
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
from panda_tpu.runtime import api as japi
from panda_tpu.runtime import manager as jmanager
from panda_tpu.runtime.errors import PandaRuntimeError as JPandaRuntimeError
from panda_tpu_torch import InitUnitType, PandaManager
from panda_tpu_torch.curves.config import BLS12_377, BLS12_381, BN254
from panda_tpu_torch.fields import mont
from panda_tpu_torch.ops import _ext, fmul, ntt_fused, ntt_mxu
from panda_tpu_torch.ops import ntt as ntt_ops
from panda_tpu_torch.reference import ntt_ref
from panda_tpu_torch.runtime import api
from panda_tpu_torch.runtime.errors import PandaError, PandaRuntimeError

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


def _wire(vals) -> bytes:
    return b"".join(FR.to_wire_int(v).to_bytes(32, "little") for v in vals)


def _raw_words(n, seed):
    """n random 256-bit input words, the first three >= r, as bytes and as
    the plain values they stand for."""
    rng = random.Random(seed)
    words = [rng.randrange(1 << 256) for _ in range(n)]
    words[:3] = [R, 2 * R + 7, (1 << 256) - 1][:n]
    data = b"".join(v.to_bytes(32, "little") for v in words)
    return data, [FR.from_wire_int(v) for v in words]


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


@pytest.mark.parametrize("log_n", [1, 4, 5, 6, 11])
def test_run_ntt_matches_oracle(log_n):
    data, vals = _raw_words(1 << log_n, log_n)
    x = mont.bytes_to_tensor(FR, data)
    tables = ntt_ops.make_tables(FR, log_n)
    w = FR.root_of_unity(log_n)
    fwd = ntt_ops.run_ntt(FR, x, tables)
    assert mont.tensor_to_bytes(fwd) == _wire(ntt_ref.ntt_oracle(FR, vals, w))
    inv = ntt_ops.run_ntt(FR, x, tables, inverse=True)
    assert mont.tensor_to_bytes(inv) == _wire(ntt_ref.intt_oracle(FR, vals,
                                                                  w))


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


@pytest.fixture(scope="module")
def api_case():
    log_n = 6
    data, vals = _raw_words(1 << log_n, 66)
    w3 = pow(FR.root_of_unity(log_n), 3, R)
    return {"log_n": log_n, "data": data, "vals": vals,
            "omega": FR.to_wire_int(w3).to_bytes(32, "little"),
            "jgm": jmanager.PandaManager.init_all(0,
                                                  jmanager.InitUnitType.NTT),
            "gm": PandaManager.init_all(0, InitUnitType.NTT, device="cpu")}


def test_byte_api_matches_jax(api_case):
    c = api_case
    gm, jgm, data, log_n = c["gm"], c["jgm"], c["data"], c["log_n"]
    out = api.ntt_bn254(gm, data, log_n)
    assert out == japi.ntt_bn254(jgm, data, log_n)
    assert out == _wire(ntt_ref.ntt_oracle(FR, c["vals"],
                                           FR.root_of_unity(log_n)))
    v1 = api.ntt_bn254_v1(gm, data, log_n, c["omega"])
    assert v1 == japi.ntt_bn254_v1(jgm, data, log_n, c["omega"])
    inv = api.intt(gm, data, log_n)
    assert inv == japi.intt(jgm, data, log_n)
    assert api.intt(gm, out, log_n) == _wire(c["vals"])


def test_byte_api_error_codes_match_jax(api_case):
    c = api_case
    data, log_n = c["data"], c["log_n"]
    bls = PandaManager.new(0, "bls12_377", device="cpu")
    jbls = jmanager.PandaManager.new(0, "bls12_377")
    for call, jcall in (
            (lambda: api.ntt(c["gm"], data[:-1], log_n),
             lambda: japi.ntt(c["jgm"], data[:-1], log_n)),
            (lambda: api.ntt(c["gm"], data, log_n - 1),
             lambda: japi.ntt(c["jgm"], data, log_n - 1)),
            (lambda: api.intt(c["gm"], data[:32 * 3], 2),
             lambda: japi.intt(c["jgm"], data[:32 * 3], 2)),
            (lambda: api.ntt_bn254(bls, data, log_n),
             lambda: japi.ntt_bn254(jbls, data, log_n)),
            (lambda: api.ntt_bn254_v1(bls, data, log_n, c["omega"]),
             lambda: japi.ntt_bn254_v1(jbls, data, log_n, c["omega"]))):
        with pytest.raises(PandaRuntimeError) as e:
            call()
        with pytest.raises(JPandaRuntimeError) as je:
            jcall()
        assert e.value.code.name == je.value.code.name
        assert e.value.code in (PandaError.INVALID_CONFIGURATION,
                                PandaError.UNSUPPORTED_CURVE)


def test_session_root_and_init_units():
    """init_ntt's root becomes the session default (as ntt_v1 with it);
    InitUnitType.ALL sets up both halves."""
    log_n = 5
    data, _ = _raw_words(1 << log_n, 5)
    omega = FR.to_wire_int(pow(FR.root_of_unity(log_n), 7, R)).to_bytes(
        32, "little")
    gm = PandaManager.init_all(0, InitUnitType.ALL, [], omega, device="cpu")
    plain = PandaManager.init_all(0, InitUnitType.NTT, device="cpu")
    assert api.ntt(gm, data, log_n) == api.ntt_v1(plain, data, log_n, omega)
    assert api.ntt(gm, data, log_n) != api.ntt(plain, data, log_n)
    gm.deinit()
    assert not gm._ntt_tables


@pytest.mark.parametrize("curve", [BLS12_377, BLS12_381],
                         ids=lambda c: c.name)
def test_bls_ntt_plain_on_cpu_and_not_on_gpu(curve):
    """The BLS scalar fields run their plain versions on CPU tensors; on
    CUDA the NTT kernels and the MSM kernels take both BLS curves and
    scalar fields beside BN254's, with ids 1 (BLS12-377) and 2
    (BLS12-381); a field they are not built for raises."""
    fr, log_n = curve.fr, 6
    rng = random.Random(7)
    vals = [rng.randrange(fr.modulus) for _ in range(1 << log_n)]
    data = b"".join(fr.to_wire_int(v).to_bytes(32, "little") for v in vals)
    gm = PandaManager.init_all(0, InitUnitType.NTT, curve=curve, device="cpu")
    alias = {"bls12_377": api.ntt_bls12_377,
             "bls12_381": api.ntt_bls12_381}[curve.name]
    out = alias(gm, data, log_n)
    want = ntt_ref.ntt_oracle(fr, vals, fr.root_of_unity(log_n))
    assert out == b"".join(fr.to_wire_int(v).to_bytes(32, "little")
                           for v in want)
    assert api.intt(gm, out, log_n) == data
    cid = {"bls12_377": 1, "bls12_381": 2}[curve.name]
    assert _ext.kernel_field("dft_apply_fused", fr, _ext.NTT_FIELDS) == cid
    assert _ext.kernel_field("dft_apply_fused", FR, _ext.NTT_FIELDS) == 0
    with pytest.raises(NotImplementedError):
        _ext.kernel_field("fmul", curve.fp, _ext.NTT_FIELDS)
    assert _ext.kernel_field("signed_digits", fr, _ext.MSM_FIELDS) == cid
    assert _ext.kernel_field("phase_a", curve, _ext.MSM_CURVES) == cid
