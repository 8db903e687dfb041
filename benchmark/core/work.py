"""The least time an H100 needs for the work of an MSM call.

Peak rates of one H100 SXM at its full 700 W limit (a copy of
``panda_tpu_torch/tools/bounds.py``).  Memory: NVIDIA's H100 data sheet,
3.35 TB/s.  32-bit integer multiply-adds: 64 per SM per clock (Hopper
architecture white paper) x 132 SMs x 1.98 GHz boost.  A CIOS Montgomery
product over N 32-bit words costs 4 N^2 + N of them (N x (2N + 1 + 2N):
a b_i's lo and hi halves, m, m p's lo and hi halves): 264 at N = 8 and
588 at N = 12.

The work is counted by the algorithm, not by what the program runs, so a
program that does less of it shows as a higher share, never as a changed
yardstick.  An MSM of n points, scalars of ``bits`` bits, window c by the
reference CUDA library's rule (``get_window_bits_count``,
``msm_cuda.cuh:21-45``: c = 16 from 2^20 to 2^26 points, 15 from 2^15, 14
at 2^13-2^14): W = ceil(bits / c) windows; n W mixed additions of a base
point into a bucket (11 products each, the a = 0 complete mixed addition);
the bucket reduction's running sums, 2 (2^c - 1) complete additions a
window (12 products each); each scalar (32 bytes) and base (two base-field
elements) read once and the result written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 64 * 132 * 1.98e9

MADD_PRODUCTS = 11       # complete mixed addition, a = 0
ADD_PRODUCTS = 12        # complete projective addition, a = 0


def cios_imads(words: int) -> int:
    return 4 * words * words + words


def window_bits(log_n: int) -> int:
    """The reference library's window width for 2^log_n points."""
    if 20 <= log_n <= 26:
        return 16
    if 15 <= log_n <= 19:
        return 15
    if 13 <= log_n <= 14:
        return 14
    return max(log_n, 3)


def least_seconds(nbytes: float, imads: float) -> float:
    """The larger of bytes over the memory rate and multiply-adds over
    their peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, imads / IMAD_PER_S)


def msm(log_n: int, scalar_bits: int, base_bytes: int) -> float:
    """Least seconds of one MSM of 2^log_n points; ``base_bytes`` is one
    base-field element's width (32 or 48)."""
    n, c = 1 << log_n, window_bits(log_n)
    windows = -(-scalar_bits // c)
    words = base_bytes // 4
    imads = cios_imads(words) * (n * windows * MADD_PRODUCTS
                                 + windows * 2 * ((1 << c) - 1) * ADD_PRODUCTS)
    nbytes = n * (32 + 2 * base_bytes) + 3 * base_bytes
    return least_seconds(nbytes, imads)

