"""Field and curve constants and plain big-integer group arithmetic.

The benchmark's own copy: the moduli, Weierstrass b and generators are
those of ``panda_tpu_torch/curves/config.py`` and ``fields/config.py``, the
Jacobian formulas those of ``panda_tpu_torch/reference/curve_ref.py``.
Nothing here imports the program, so the reference cannot share its bugs.

Wire format: little-endian Montgomery form, R = 2^(8 n_bytes), where
n_bytes = ceil(bits / 64) * 8 (32 bytes for 254/253-bit fields, 48 for the
377/381-bit base fields).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Field:
    name: str
    modulus: int

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def n_bytes(self) -> int:
        return -(-self.bits // 64) * 8

    @property
    def wire_r(self) -> int:
        return 1 << (8 * self.n_bytes)

    def to_wire(self, a: int) -> int:
        """Plain integer -> the wire (Montgomery) integer."""
        return a * self.wire_r % self.modulus

    def from_wire(self, v: int) -> int:
        return v * pow(self.wire_r, -1, self.modulus) % self.modulus


@dataclass(frozen=True)
class Curve:
    """Short Weierstrass y^2 = x^3 + b over fp; G1 of prime order fr."""
    name: str
    fp: Field
    fr: Field
    b: int
    gen: tuple


BN254 = Curve(
    "bn254",
    Field("bn254_fp", 21888242871839275222246405745257275088696311157297823662689037894645226208583),
    Field("bn254_fr", 21888242871839275222246405745257275088548364400416034343698204186575808495617),
    3, (1, 2))

BLS12_377 = Curve(
    "bls12_377",
    Field("bls12_377_fp", 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001),
    Field("bls12_377_fr", 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001),
    1, (0x008848DEFE740A67C8FC6225BF87FF5485951E2CAA9D41BB188282C8BD37CB5CD5481512FFCD394EEAB9B16EB21BE9EF,
        0x01914A69C5102EFF1F674F5D30AFEEC4BD7FB348CA3E52D96D182AD44FB82305C2FE3D3634A9591AFD82DE55559C8EA6))

BLS12_381 = Curve(
    "bls12_381",
    Field("bls12_381_fp", 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB),
    Field("bls12_381_fr", 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001),
    4, (0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
        0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1))

CURVES = {c.name: c for c in (BN254, BLS12_377, BLS12_381)}

# --- affine and Jacobian arithmetic (None is the affine identity) ---------

JINF = (0, 1, 0)


def on_curve(curve: Curve, pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - curve.b) % curve.fp.modulus == 0


def add(curve: Curve, a, b):
    """Affine addition (one inversion)."""
    p = curve.fp.modulus
    if a is None:
        return b
    if b is None:
        return a
    (x1, y1), (x2, y2) = a, b
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return x3, (lam * (x1 - x3) - y1) % p


def jadd(p: int, a, b):
    if a[2] == 0:
        return b
    if b[2] == 0:
        return a
    x1, y1, z1 = a
    x2, y2, z2 = b
    z1z1, z2z2 = z1 * z1 % p, z2 * z2 % p
    u1, u2 = x1 * z2z2 % p, x2 * z1z1 % p
    s1, s2 = y1 * z2 * z2z2 % p, y2 * z1 * z1z1 % p
    if u1 == u2:
        return JINF if (s1 + s2) % p == 0 else jdbl(p, a)
    h = (u2 - u1) % p
    i = 4 * h * h % p
    j = h * i % p
    r = 2 * (s2 - s1) % p
    v = u1 * i % p
    x3 = (r * r - j - 2 * v) % p
    y3 = (r * (v - x3) - 2 * s1 * j) % p
    z3 = ((z1 + z2) ** 2 - z1z1 - z2z2) % p * h % p
    return x3, y3, z3


def jdbl(p: int, a):
    x1, y1, z1 = a
    if z1 == 0:
        return a
    aa, b = x1 * x1 % p, y1 * y1 % p
    c = b * b % p
    d = 2 * ((x1 + b) ** 2 - aa - c) % p
    e = 3 * aa % p
    x3 = (e * e - 2 * d) % p
    return x3, (e * (d - x3) - 8 * c) % p, 2 * y1 * z1 % p


def to_affine(p: int, a):
    if a[2] == 0:
        return None
    zi = pow(a[2], -1, p)
    return a[0] * zi * zi % p, a[1] * zi * zi * zi % p


def mul(curve: Curve, pt, k: int):
    """k * pt (affine in, affine out), double-and-add, k taken mod r."""
    p = curve.fp.modulus
    k %= curve.fr.modulus
    acc, a = JINF, (JINF if pt is None else (pt[0], pt[1], 1))
    while k:
        if k & 1:
            acc = jadd(p, acc, a)
        a = jdbl(p, a)
        k >>= 1
    return to_affine(p, acc)


def blob(curve: Curve, pt) -> bytes:
    """The MSM result blob: x, y, z as wire bytes of the base field, affine
    (z = 1); the identity is (0, 1, 0)."""
    f = curve.fp
    x, y, z = (0, 1, 0) if pt is None else (*pt, 1)
    return b"".join(f.to_wire(v).to_bytes(f.n_bytes, "little")
                    for v in (x, y, z))
