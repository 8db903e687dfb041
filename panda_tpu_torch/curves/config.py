"""Curve parameter packs (short Weierstrass, a = 0): the port's own copy of
``panda_tpu/curves/config.py``, with the same curves and constants.

BLS12-377 carries b = 1, its correct value (the reference CUDA library's
header says 3, which its formulas never read); the complete formulas here
do read b.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.config import (BLS12_377_FP, BLS12_377_FR, BLS12_381_FP,
                             BLS12_381_FR, BN254_FP, BN254_FR, FieldSpec)


@dataclass(frozen=True)
class CurveSpec:
    name: str
    fp: FieldSpec          # base field (point coordinates)
    fr: FieldSpec          # scalar field
    b: int                 # Weierstrass b (a is always 0)
    # affine generator (integer coordinates), for tests/sanity only
    gen_x: int
    gen_y: int

    @property
    def b3(self) -> int:
        return 3 * self.b

    def __hash__(self):
        return hash(self.name)


BN254 = CurveSpec(name="bn254", fp=BN254_FP, fr=BN254_FR, b=3, gen_x=1,
                  gen_y=2)

BLS12_377 = CurveSpec(
    name="bls12_377",
    fp=BLS12_377_FP,
    fr=BLS12_377_FR,
    b=1,
    gen_x=0x008848DEFE740A67C8FC6225BF87FF5485951E2CAA9D41BB188282C8BD37CB5CD5481512FFCD394EEAB9B16EB21BE9EF,
    gen_y=0x01914A69C5102EFF1F674F5D30AFEEC4BD7FB348CA3E52D96D182AD44FB82305C2FE3D3634A9591AFD82DE55559C8EA6,
)

BLS12_381 = CurveSpec(
    name="bls12_381",
    fp=BLS12_381_FP,
    fr=BLS12_381_FR,
    b=4,
    gen_x=0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    gen_y=0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)

CURVES = {"bn254": BN254, "bls12_377": BLS12_377, "bls12_381": BLS12_381}
