"""Pure-Python big-int field oracle.

The port's own copy of ``panda_tpu/reference/field_ref.py``, in the port's
Montgomery domain (R = the wire radix, ``FieldSpec.wire_r``).  Python
integers cannot share a bug with the word kernels or their plain versions.
"""

from __future__ import annotations

from ..fields.config import FieldSpec


class F:
    """Field element in Montgomery form (thin wrapper over Python ints)."""

    __slots__ = ("spec", "v")

    def __init__(self, spec: FieldSpec, mont_value: int):
        self.spec = spec
        self.v = mont_value % spec.modulus

    @classmethod
    def from_int(cls, spec: FieldSpec, a: int) -> "F":
        return cls(spec, a % spec.modulus * spec.wire_r % spec.modulus)

    def to_int(self) -> int:
        p = self.spec.modulus
        return self.v * pow(self.spec.wire_r, -1, p) % p

    def __add__(self, o): return F(self.spec, self.v + o.v)
    def __sub__(self, o): return F(self.spec, self.v - o.v)
    def __neg__(self): return F(self.spec, -self.v)

    def __mul__(self, o):
        p = self.spec.modulus
        return F(self.spec, self.v * o.v * pow(self.spec.wire_r, -1, p) % p)

    def inv(self) -> "F":
        p, r = self.spec.modulus, self.spec.wire_r
        return F(self.spec, pow(self.v, -1, p) * r % p * r % p)

    def __eq__(self, o): return self.spec is o.spec and self.v == o.v
    def __repr__(self): return f"F({self.spec.name}, {hex(self.v)})"

    def is_zero(self) -> bool:
        return self.v == 0


def mont_mul_int(spec: FieldSpec, a: int, b: int) -> int:
    """Plain-int Montgomery product (operands already in Montgomery form)."""
    return a * b * pow(spec.wire_r, -1, spec.modulus) % spec.modulus
