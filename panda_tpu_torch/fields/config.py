"""Field parameter packs: the port's own copy of ``panda_tpu/fields/config.py``.

The same fields, moduli, generators and two-adicities, with only what the
port reaches: the bit and byte widths, the wire radix (which is the port's
Montgomery radix, R = 2^(8 n_bytes)), the wire conversions and the roots of
unity.  The JAX package's 15-bit-limb constants are not the port's
representation and are left out (``fields/mont.py`` keeps the one limb width
it needs to carry JAX arrays across).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass


@dataclass(frozen=True)
class FieldSpec:
    """Constants of one prime field; hashable, so it can key caches."""

    name: str
    modulus: int
    # Generator of the multiplicative group (used for NTT roots); 0 if unused.
    generator: int = 0
    # Largest s with 2^s | modulus - 1 (two-adicity); 0 if unused.
    two_adicity: int = 0

    def __post_init__(self):
        if self.modulus % 2 == 0:
            raise ValueError("modulus must be odd")

    @functools.cached_property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @functools.cached_property
    def n_bytes(self) -> int:
        """Wire-format width: ceil(bits / 64) * 8 little-endian bytes (32 for
        254-bit fields, 48 for the 377/381-bit base fields)."""
        return -(-self.bits // 64) * 8

    @functools.cached_property
    def wire_r(self) -> int:
        """The wire Montgomery radix 2^(8 n_bytes), the port's R."""
        return 1 << (8 * self.n_bytes)

    def to_wire_int(self, a: int) -> int:
        """Plain int -> wire-format (Montgomery, R_wire) integer value."""
        return a * self.wire_r % self.modulus

    def from_wire_int(self, v: int) -> int:
        return v * pow(self.wire_r, -1, self.modulus) % self.modulus

    def root_of_unity(self, log_n: int) -> int:
        """Primitive 2^log_n-th root of unity (plain integer form)."""
        if not self.two_adicity or not self.generator:
            raise ValueError(f"{self.name} has no configured 2-adic subgroup")
        if log_n > self.two_adicity:
            raise ValueError(
                f"log_n={log_n} exceeds two-adicity {self.two_adicity}")
        return pow(self.generator, (self.modulus - 1) >> log_n, self.modulus)

    def __hash__(self):
        return hash((self.name, self.modulus))

    def __repr__(self):
        return f"FieldSpec({self.name}, {self.bits} bits)"


# BN254 Fr's NTT generator 7 and two-adicity 28 follow the reference CUDA
# library's parameter pack (halo2curves convention).

BN254_FP = FieldSpec(
    name="bn254_fp",
    modulus=21888242871839275222246405745257275088696311157297823662689037894645226208583,
)

BN254_FR = FieldSpec(
    name="bn254_fr",
    modulus=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=7,
    two_adicity=28,
)

BLS12_377_FP = FieldSpec(
    name="bls12_377_fp",
    modulus=0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
)

BLS12_377_FR = FieldSpec(
    name="bls12_377_fr",
    modulus=0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001,
    generator=22,
    two_adicity=47,
)

BLS12_381_FP = FieldSpec(
    name="bls12_381_fp",
    modulus=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
)

BLS12_381_FR = FieldSpec(
    name="bls12_381_fr",
    modulus=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    generator=7,
    two_adicity=32,
)

ALL_FIELDS = (BN254_FP, BN254_FR, BLS12_377_FP, BLS12_377_FR,
              BLS12_381_FP, BLS12_381_FR)
