"""Scalar preparation for the MSM: from-Montgomery + signed-digit recode.

Counterpart of ``panda_tpu/ops/digits_pallas.py``; the kernel is
``csrc/digits.cu``.  Input: (8, n) int32 scalar words in the wire
Montgomery form (R = 2^256, any value below 2^256).  Output: ``mags``
(W, n) int32 in [0, 2^(c-1)] and ``negs`` (W, n) bool, equal to
``panda_tpu.ops.msm.extract_signed_digits`` of the canonical scalars.
"""

from __future__ import annotations

import torch

from ..fields import mont
from ..fields.config import FieldSpec
from . import _ext
from ._ext import I32, I64, P


def signed_digits_plain(spec: FieldSpec, scalars: torch.Tensor, c: int,
                        W: int):
    """Plain version: canonical integers as 16-bit limbs, then the recode
    with the carry of a negative digit into the next window."""
    s16 = mont.to_l16(mont.from_mont(spec, scalars))          # (16, n)
    L = s16.shape[0]
    mask, half, full = (1 << c) - 1, 1 << (c - 1), 1 << c
    mags, negs = [], []
    carry = torch.zeros_like(s16[0])
    for w in range(W):
        i, sh = divmod(w * c, mont.LIMB)
        d = torch.zeros_like(s16[0])
        for k in range(3):                     # c <= 16 spans <= 2 limbs
            if i + k < L:
                part = s16[i + k] << (mont.LIMB * k)
                d = d | (part >> sh)
        e = (d & mask) + carry
        neg = e > half
        mags.append(torch.where(neg, full - e, e))
        negs.append(neg)
        carry = neg.to(torch.int64)
    return torch.stack(mags).to(torch.int32), torch.stack(negs)


def signed_digits(spec: FieldSpec, scalars: torch.Tensor, c: int, W: int):
    """(mags, negs) of the W-window signed recode of Montgomery scalars."""
    if not 1 <= c <= 16:
        raise ValueError("window width must be in [1, 16]")
    if _ext.on_cpu("signed_digits", scalars):
        return signed_digits_plain(spec, scalars, c, W)
    _ext.kernel_field("signed_digits", spec, _ext.MSM_FIELDS)
    scalars = scalars.contiguous()
    _ext.check_cuda("signed_digits", scalars)
    if scalars.shape[0] != mont.n_words(spec):
        raise ValueError("signed_digits: scalars must be (8, n) words")
    n = scalars.shape[1]
    mags = torch.empty((W, n), dtype=torch.int32, device=scalars.device)
    negs = torch.empty((W, n), dtype=torch.bool, device=scalars.device)
    _ext.launch("digits", "ptt_signed_digits", [P, P, P, I64, I32, I32],
                [scalars.data_ptr(), mags.data_ptr(), negs.data_ptr(), n, c,
                 W], scalars.device)
    return mags, negs
