"""Per-window digit histogram for the MSM bucket-run locator.

Counterpart of ``panda_tpu/ops/hist_pallas.py``; the kernel is
``csrc/hist.cu`` (bins in shared memory, one shared atomic a digit,
instead of the TPU's one-hot matrix products; the blocks a window come from
the build's occupancy, :func:`hist_threads`).  ``digits``: (W, N) int32 in
[0, D] plus dead keys > D; returns
(W, D) int32 counts of digit == b for b = 1..D (digit 0 and dead keys are
ignored).  Counts are exact, so kernel and plain version agree exactly.
"""

from __future__ import annotations

import torch

from . import _ext
from ._ext import I32, I64, P


def hist_counts_plain(digits: torch.Tensor, D: int) -> torch.Tensor:
    W = digits.shape[0]
    d = digits.to(torch.int64).clamp(0, D + 1)
    counts = torch.zeros((W, D + 2), dtype=torch.int64, device=digits.device)
    counts.scatter_add_(1, d, torch.ones_like(d))
    return counts[:, 1:D + 1].to(torch.int32)


def hist_counts(digits: torch.Tensor, D: int) -> torch.Tensor:
    if _ext.on_cpu("hist_counts", digits):
        return hist_counts_plain(digits, D)
    digits = digits.contiguous()
    _ext.check_cuda("hist_counts", digits)
    W, N = digits.shape
    counts = torch.zeros((W, D), dtype=torch.int32, device=digits.device)
    _ext.launch("hist", "ptt_hist_counts", [P, P, I64, I64, I32, I32],
                [digits.data_ptr(), counts.data_ptr(), W, N, D,
                 hist_threads(D, digits.device)], digits.device)
    return counts


def hist_threads(D: int, device: torch.device) -> int:
    """Threads of one full wave of csrc/hist.cu's kernel with D bins in
    shared memory on the card ``device``, as the kernel's build allows."""
    return _ext.resident_threads("hist", "ptt_hist_threads", D, device)
