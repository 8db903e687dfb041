"""The NTT slice: the port's four-step transform on the CPU against the
big-integer NTT oracle, and the BLS scalar fields' plain path.

Inputs include words >= r (any value below 2^256 is a valid input word).
The byte API is tested in ``test_torch_ntt_byte_api.py``, the plain fmul
and DFT against the JAX package's Pallas kernels in
``test_torch_ntt_kernels.py``.
"""

import random

import pytest
import torch

torch.set_num_threads(1)

from panda_tpu_torch import InitUnitType, PandaManager
from panda_tpu_torch.curves.config import BLS12_377, BLS12_381, BN254
from panda_tpu_torch.fields import mont
from panda_tpu_torch.ops import _ext
from panda_tpu_torch.ops import ntt as ntt_ops
from panda_tpu_torch.reference import ntt_ref
from panda_tpu_torch.runtime import api
from tests.jax_release import release_jax_programs  # noqa: F401

FR = BN254.fr
R = FR.modulus


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
