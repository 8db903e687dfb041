"""Batched length-K NTT as one byte-digit product against a constant matrix.

Counterpart of ``panda_tpu/ops/ntt_fused.py::dft_apply_fused`` and of the
DFT-of-constants matrix of ``panda_tpu/ops/ntt_mxu.py``; the kernel is
``csrc/dft.cu`` (BN254 Fr, BLS12-377 Fr and BLS12-381 Fr).  ``x`` is
(W, K, nb) int32 words (W = 8, any value below 2^256), transformed along
axis 1:

    y[k] = scale * sum_j w^(j k) x[j]        (Montgomery form, natural order)

The digits are the 4 W bytes of each element, the matrix holds the bytes of
C(j, k, i) = w^(j k) * scale * R * 2^(8 i) mod p, so the byte-position sums
regroup into V_k = sum_{j,i} d_{j,i} C(j, k, i) < K * 4W * 255 * p and one
Montgomery reduction gives y[k] = V_k / R in [0, 2p) (canonical with
``canonical_out``, and always for BLS12-381 Fr, whose values stay below p:
``mont.canon``).  The JAX package's fold needs its R >= 4096 p; with the
port's R = 2^256 the reduction replaces it (see ``csrc/dft.cu``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import mont
from ..fields.config import FieldSpec
from . import _ext
from ._ext import I32, I64, P

DIGIT_MAX = 255


@functools.lru_cache(maxsize=None)
def check_bounds(spec: FieldSpec, log_k: int) -> None:
    """The bounds the kernel and the plain version rely on, for K = 2^log_k
    (asserted when a plan is built, as the JAX package's ``_FoldPlan``)."""
    K, D, p = 1 << log_k, spec.n_bytes, spec.modulus
    acc_bound = K * D * DIGIT_MAX * DIGIT_MAX
    assert acc_bound < 1 << 31, "int32 accumulator overflow"   # exact in f64
    value_bound = K * D * DIGIT_MAX * p          # V < this, one extra word
    assert value_bound + (p << 32) < 1 << (8 * D + 32), "REDC overflows"
    assert value_bound < mont.radix(spec) * p, "REDC output not below 2p"


@functools.lru_cache(maxsize=64)
def _matrix_bytes(spec: FieldSpec, log_k: int, omega: int,
                  scale: int) -> np.ndarray:
    K, D, p = 1 << log_k, spec.n_bytes, spec.modulus
    out = np.empty((K, D, K, D), np.uint8)               # [j, i, k, o]
    R = mont.radix(spec)
    for k in range(K):
        w_k = pow(omega, k, p)
        c = scale * R % p                                 # j = 0
        for j in range(K):
            blob = b"".join(((c << (8 * i)) % p).to_bytes(D, "little")
                            for i in range(D))
            out[j, :, k, :] = np.frombuffer(blob, np.uint8).reshape(D, D)
            c = c * w_k % p
    W = D // 4
    return np.ascontiguousarray(
        out.reshape(K, W, 4, K, D).transpose(0, 1, 3, 4, 2))


def dft_matrix(spec: FieldSpec, log_k: int, omega: int, scale: int = 1,
               device=None) -> torch.Tensor:
    """uint8 (K, W, K, 4W, 4) matrix: [j, w, k, o, q] = byte o of
    w^(j k) * scale * R * 2^(8 (4 w + q)) mod p.  ``omega`` is a K-th root
    of unity and ``scale`` a plain integer (n^-1 for the inverse's top
    level), both plain (not Montgomery) integers."""
    check_bounds(spec, log_k)
    return torch.from_numpy(
        _matrix_bytes(spec, log_k, omega % spec.modulus,
                      scale % spec.modulus)).to(device)


def dft_apply_fused_plain(spec: FieldSpec, x: torch.Tensor, log_k: int,
                          mat: torch.Tensor,
                          canonical_out: bool = False) -> torch.Tensor:
    """Plain version: the same digits and matrix, the byte-position sums as
    a float64 product (every sum is an integer below 2^31, so exact; torch
    has no integer matrix product on CUDA), then the same reduction in
    16-bit limbs."""
    W, K, nb = x.shape
    D = 4 * W
    u = x.to(torch.int64) & 0xFFFFFFFF
    d = torch.stack([(u >> (8 * q)) & DIGIT_MAX for q in range(4)], dim=2)
    d = d.permute(1, 0, 2, 3).reshape(K * D, nb)         # rows (j, w, q)
    a = mat.permute(2, 3, 0, 1, 4).reshape(K * D, K * D)  # rows (k, o)
    acc = (a.to(torch.float64) @ d.to(torch.float64)).to(torch.int64)
    acc = acc.reshape(K, D, nb)
    L = 2 * W
    t = acc.new_zeros((2 * L + 1, K, nb))
    t[:L] = (acc[:, 0::2] + (acc[:, 1::2] << 8)).permute(1, 0, 2)
    out = mont.redc16(spec, t)
    if canonical_out or mont.canon(spec):
        out = mont.canonical16(spec, out)
    return mont.from_l16(out)


def dft_apply_fused(spec: FieldSpec, x: torch.Tensor, log_k: int,
                    mat: torch.Tensor,
                    canonical_out: bool = False) -> torch.Tensor:
    """Batched length-K NTT along axis 1 of (8, K, nb) words, K = 2^log_k
    <= 32, any nb; ``mat`` from :func:`dft_matrix`."""
    W, K, nb = x.shape
    if K != 1 << log_k or mat.shape != (K, W, K, 4 * W, 4):
        raise ValueError(f"dft_apply_fused: x {tuple(x.shape)} and matrix "
                         f"{tuple(mat.shape)} do not match K = 2^{log_k}")
    check_bounds(spec, log_k)
    if _ext.on_cpu("dft_apply_fused", x):
        return dft_apply_fused_plain(spec, x, log_k, mat, canonical_out)
    field = _ext.kernel_field("dft_apply_fused", spec, _ext.NTT_FIELDS)
    x, mat = x.contiguous(), mat.contiguous()
    _ext.check_cuda("dft_apply_fused", x)
    if W != 8 or K > 32:
        raise ValueError("dft_apply_fused: the kernel takes 8 words, K <= 32")
    if mat.dtype != torch.uint8 or mat.device != x.device \
            or mat.data_ptr() % 16:
        raise ValueError("dft_apply_fused: the matrix must be a 16-byte "
                         "aligned uint8 tensor on x's device")
    out = torch.empty_like(x)
    _ext.launch("dft", "ptt_dft", [P, P, P, I64, I32, I32, I32],
                [x.data_ptr(), mat.data_ptr(), out.data_ptr(), nb, K,
                 int(canonical_out), field], x.device)
    return out
