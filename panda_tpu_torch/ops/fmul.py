"""Elementwise Montgomery multiply of two word tensors.

Counterpart of ``panda_tpu/ops/point_pallas.py::fmul``; the kernel is
``csrc/fmul.cu`` (BN254 Fr and BLS12-377 Fr).  ``a`` and ``b`` are (8, N)
int32 words in the port's Montgomery form, each below 2p; the result
a b R^-1 is below 2p, or
canonical in [0, p) with ``canonical_out``.  Kernel and plain version
compute the same (a b + M p) / R with the unique M < R, so they agree bit
for bit.
"""

from __future__ import annotations

import torch

from ..fields import mont
from ..fields.config import FieldSpec
from . import _ext
from ._ext import I32, I64, P


def fmul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor,
               canonical_out: bool = False) -> torch.Tensor:
    out = mont.mul(spec, a, b)
    return mont.canonical(spec, out) if canonical_out else out


def fmul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor,
         canonical_out: bool = False) -> torch.Tensor:
    if _ext.on_cpu("fmul", a):
        return fmul_plain(spec, a, b, canonical_out)
    field = _ext.kernel_field("fmul", spec, _ext.NTT_FIELDS)
    a, b = a.contiguous(), b.contiguous()
    _ext.check_cuda("fmul", a, b)
    if a.shape != b.shape or a.dim() != 2 or a.shape[0] != mont.n_words(spec):
        raise ValueError(f"fmul: expected two (8, N) tensors, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    out = torch.empty_like(a)
    _ext.launch("fmul", "ptt_fmul", [P, P, P, I64, I32, I32],
                [a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1],
                 int(canonical_out), field], a.device)
    return out
