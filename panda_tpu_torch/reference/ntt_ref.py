"""Pure-Python NTT oracle (big ints, O(n log n) recursion).

The port's own copy of ``panda_tpu/reference/ntt_ref.py``.  Independent of
the kernels; defines the transform contract
X[k] = sum_j x[j] * omega^(j k) mod p that every engine must match.
"""

from __future__ import annotations

from ..fields.config import FieldSpec


def ntt_oracle(spec: FieldSpec, values, omega: int):
    """Forward NTT of plain-integer values with root omega."""
    n = len(values)
    p = spec.modulus
    if n == 1:
        return list(values)
    assert n % 2 == 0
    w2 = omega * omega % p
    even = ntt_oracle(spec, values[0::2], w2)
    odd = ntt_oracle(spec, values[1::2], w2)
    out = [0] * n
    w = 1
    for i in range(n // 2):
        t = w * odd[i] % p
        out[i] = (even[i] + t) % p
        out[i + n // 2] = (even[i] - t) % p
        w = w * omega % p
    return out


def intt_oracle(spec: FieldSpec, values, omega: int):
    n = len(values)
    p = spec.modulus
    inv_n = pow(n, -1, p)
    y = ntt_oracle(spec, values, pow(omega, -1, p))
    return [v * inv_n % p for v in y]
