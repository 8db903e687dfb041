"""The least time an H100 could take for a kernel's work: the yardstick of
``chip_smoke.py`` and the measurement tools.

Peak rates of one H100 SXM at its full 700 W limit.  Memory and int8
tensor cores: NVIDIA's H100 data sheet.  32-bit integer multiply-add: 64
per SM per clock (Hopper architecture white paper) x 132 SMs x 1.98 GHz
boost.  A CIOS multiply over N words is 4 N^2 + N of them (N x (2N + 1 +
2N): a b_i's lo and hi halves, m, m p's lo and hi halves), 264 at N = 8
and 588 at N = 12.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
IMAD_PER_S = 64 * 132 * 1.98e9


def cios_imads(words: int) -> int:
    return 4 * words * words + words


MONT_MUL_IMADS = cios_imads(8)


def bound(nbytes: float, ops: float, rate: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}
