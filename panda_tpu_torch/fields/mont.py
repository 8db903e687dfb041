"""Plain Montgomery field arithmetic on PyTorch tensors.

Counterpart of ``panda_tpu/fields/mont.py``.  The port's own representation:

* an element is ``n_bytes / 4`` little-endian 32-bit words (8 for the
  BN254 fields), stored limbs-first as an ``(W, *batch)`` ``torch.int32``
  tensor holding the uint32 bit patterns ("words");
* the Montgomery radix is R = 2^(8 * n_bytes), the wire radix
  (2^256 for BN254), so wire bytes ARE the internal form: ingest is a
  reinterpretation, output a canonicalisation;
* every stored value lies in [0, 2p) where 4p < R: a Montgomery product
  of two such values is (a b + M p) / R < 4p^2 / R + p < 2p with no final
  subtraction, and add/sub end with one conditional +-2p;
* where 4p > R (BLS12-381 Fr only: r ~ 0.453 * 2^256, so 2r < R < 4r, see
  :func:`canon`) every stored value lies in [0, p): a product of a, b < p
  is < p^2 / R + p < 1.46p and ends with one conditional -p (a < R times
  b < p is < 2p, so the same subtraction lands it below p), a + b < 2p < R
  ends with a conditional -p and a - b with a conditional +p; canonical16
  is then the identity on stored values.  (Under [0, 2p) the product of
  two values near 2p passes R and its top is lost.)

The CUDA kernels (``csrc/field.cuh``) work on the words directly.  This
module is their plain version: torch on the CPU has no uint32 add, shift or
compare, so it widens words to 16-bit limbs in ``int64`` ("L16" form,
``2 W`` limbs, same R) and computes there.  The schoolbook product is one
``(L, L, *batch)`` outer product summed along its anti-diagonals, followed by
L interleaved reduction steps.  The results are bit-identical to the
kernels': both compute (a b + M p) / R with the unique M < R.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .config import FieldSpec

LIMB = 16
MASK = (1 << LIMB) - 1

# The JAX package's limb width (15-bit limbs, R_jax = 2^(15 L) >= 4096 p),
# needed only to carry its arrays across (from_jax_limbs / to_jax_limbs).
JAX_LIMB_BITS = 15


def n_words(spec: FieldSpec) -> int:
    """32-bit words per element."""
    return spec.n_bytes // 4


def radix(spec: FieldSpec) -> int:
    """The port's Montgomery radix R (= the wire radix)."""
    return spec.wire_r


def canon(spec: FieldSpec) -> bool:
    """True where 4p > R, so stored values stay in [0, p) (BLS12-381 Fr);
    False for the [0, 2p) fields."""
    return radix(spec) < 4 * spec.modulus


def _int_l16(v: int, L: int) -> list:
    return [(v >> (LIMB * i)) & MASK for i in range(L)]


class _Consts(NamedTuple):
    p: torch.Tensor          # (L,) int64 16-bit limbs of p
    bound: torch.Tensor      # add/sub modulus: p where canon(spec), else 2p
    r2: torch.Tensor         # R^2 mod p
    unity: torch.Tensor      # plain integer 1
    diag: torch.Tensor       # (L*L,) anti-diagonal index i + j
    ninv: int                # -p^-1 mod 2^16


@functools.lru_cache(maxsize=None)
def _consts(spec: FieldSpec, device: torch.device) -> _Consts:
    L = 2 * n_words(spec)
    p, r = spec.modulus, radix(spec)

    def t(v):
        return torch.tensor(_int_l16(v, L), dtype=torch.int64, device=device)

    ii = np.arange(L)
    diag = torch.tensor((ii[:, None] + ii[None, :]).reshape(-1),
                        dtype=torch.int64, device=device)
    return _Consts(t(p), t(p if canon(spec) else 2 * p), t(r * r % p), t(1),
                   diag, (-pow(p, -1, 1 << LIMB)) % (1 << LIMB))


def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(L,) constant -> (L, 1, ..., 1) broadcastable over ``ndim`` batch dims."""
    return v.view((v.shape[0],) + (1,) * ndim)


# ---------------------------------------------------------------------------
# Words <-> L16
# ---------------------------------------------------------------------------

def to_l16(w: torch.Tensor) -> torch.Tensor:
    """(W, *batch) int32 words -> (2W, *batch) int64 16-bit limbs."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack((u & MASK, u >> LIMB), dim=1).reshape(
        (2 * w.shape[0],) + tuple(w.shape[1:]))


def from_l16(a: torch.Tensor) -> torch.Tensor:
    """(2W, *batch) normalised 16-bit limbs -> (W, *batch) int32 words."""
    a = a.reshape((a.shape[0] // 2, 2) + tuple(a.shape[1:]))
    u = a[:, 0] | (a[:, 1] << LIMB)
    return (u - ((u >> 31) << 32)).to(torch.int32)


def _norm(t: torch.Tensor):
    """Carry-propagate rows of signed int64 columns along dim 0.

    Returns (16-bit limbs, final signed carry).  Arithmetic shifts make a
    negative column borrow from the next one."""
    rows = []
    carry = None
    for i in range(t.shape[0]):
        s = t[i] if carry is None else t[i] + carry
        rows.append(s & MASK)
        carry = s >> LIMB
    return torch.stack(rows), carry


# ---------------------------------------------------------------------------
# L16 arithmetic (stored values: [0, 2p), or [0, p) where canon(spec))
# ---------------------------------------------------------------------------

def redc16(spec: FieldSpec, t: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction (t + M p) / R with the unique M < R, for
    (>= 2L + 1, *batch) int64 columns of t < R p (normalised or not, each
    column below 2^40); the result is < t / R + p, as L limbs.  ``t`` is
    updated in place."""
    c = _consts(spec, t.device)
    L = c.p.shape[0]
    p = _col(c.p, t.dim() - 1)
    for i in range(L):
        m = (t[i] * c.ninv) & MASK
        t[i:i + L] += m * p
        t[i + 1] += t[i] >> LIMB
    out, _ = _norm(t[L:])
    return out[:L]


def mul16(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a b R^-1 mod p; output < 2p for inputs < 2p, or
    < p for inputs < p where canon(spec) (one conditional -p).

    Exact for any inputs < R whose result fits (e.g. a < R, b < p gives a
    result < 2p, and < p where canon(spec)): every column stays below
    2^40."""
    c = _consts(spec, a.device)
    a, b = torch.broadcast_tensors(a, b)
    L = a.shape[0]
    batch = tuple(a.shape[1:])
    prod = (a.unsqueeze(1) * b.unsqueeze(0)).reshape((L * L,) + batch)
    t = a.new_zeros((2 * L + 1,) + batch)
    t.index_add_(0, c.diag, prod)
    out = redc16(spec, t)
    return canonical16(spec, out) if canon(spec) else out


def _pick(cand: torch.Tensor, use_second: torch.Tensor) -> torch.Tensor:
    return torch.where(use_second.unsqueeze(0), cand[:, 1], cand[:, 0])


def add16(spec: FieldSpec, a, b):
    """(a + b) mod 2p, or mod p where canon(spec)."""
    c = _consts(spec, a.device)
    s = a + b
    cand, carry = _norm(torch.stack((s, s - _col(c.bound, s.dim() - 1)), 1))
    return _pick(cand, carry[1] >= 0)


def sub16(spec: FieldSpec, a, b):
    """(a - b) mod 2p, or mod p where canon(spec)."""
    c = _consts(spec, a.device)
    d = a - b
    cand, carry = _norm(torch.stack((d, d + _col(c.bound, d.dim() - 1)), 1))
    return _pick(cand, carry[0] < 0)


def neg16(spec: FieldSpec, a):
    return sub16(spec, torch.zeros_like(a), a)


def canonical16(spec: FieldSpec, a):
    """[0, 2p) -> [0, p) (the identity on [0, p), where canon(spec) keeps
    every stored value)."""
    c = _consts(spec, a.device)
    cand, carry = _norm(torch.stack((a, a - _col(c.p, a.dim() - 1)), 1))
    return _pick(cand, carry[1] >= 0)


def mul_small16(spec: FieldSpec, a, k: int):
    """k a mod 2p (mod p where canon(spec)) by a double-and-add chain
    (k = 9 for BN254's 3b)."""
    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = add16(spec, acc, acc)
        if bit == "1":
            acc = a if acc is None else add16(spec, acc, a)
    return acc


def const16(v: int, like: torch.Tensor) -> torch.Tensor:
    """Integer constant ``v`` (already in the wanted domain) broadcast like
    ``like``."""
    L = like.shape[0]
    t = torch.tensor(_int_l16(v, L), dtype=torch.int64, device=like.device)
    return _col(t, like.dim() - 1).expand(like.shape)


def pow16(spec: FieldSpec, a, e: int):
    """a^e (e >= 1) in the Montgomery domain, square-and-multiply."""
    acc = a
    for bit in bin(e)[3:]:
        acc = mul16(spec, acc, acc)
        if bit == "1":
            acc = mul16(spec, acc, a)
    return acc


def inv16(spec: FieldSpec, a):
    """Fermat inverse a^(p-2); maps 0 to 0."""
    return pow16(spec, a, spec.modulus - 2)


# ---------------------------------------------------------------------------
# Word-level API
# ---------------------------------------------------------------------------

def mul(spec: FieldSpec, a, b):
    return from_l16(mul16(spec, to_l16(a), to_l16(b)))


def add(spec: FieldSpec, a, b):
    return from_l16(add16(spec, to_l16(a), to_l16(b)))


def sub(spec: FieldSpec, a, b):
    return from_l16(sub16(spec, to_l16(a), to_l16(b)))


def neg(spec: FieldSpec, a):
    return from_l16(neg16(spec, to_l16(a)))


def canonical(spec: FieldSpec, a):
    return from_l16(canonical16(spec, to_l16(a)))


def reduce_wire(spec: FieldSpec, a):
    """Any value < R -> canonical [0, p): conditional subtractions of
    2^j p for j = floor(log2(R / p)) down to 0 (4p, 2p, p for BN254)."""
    a16 = to_l16(a)
    top = (radix(spec) // spec.modulus).bit_length() - 1
    for j in range(top, -1, -1):
        cp = const16(spec.modulus << j, a16)
        cand, carry = _norm(torch.stack((a16, a16 - cp), 1))
        a16 = _pick(cand, carry[1] >= 0)
    return from_l16(a16)


def to_mont(spec: FieldSpec, a):
    """Plain integers -> Montgomery form (multiply by R^2)."""
    a16 = to_l16(a)
    return from_l16(mul16(spec, a16, _col(_consts(spec, a.device).r2,
                                          a.dim() - 1)))


def from_mont(spec: FieldSpec, a):
    """Montgomery form (any value < R) -> canonical plain integers."""
    a16 = to_l16(a)
    one = _col(_consts(spec, a.device).unity, a.dim() - 1)
    return from_l16(canonical16(spec, mul16(spec, a16, one)))


def batch_inverse(spec: FieldSpec, a):
    """Elementwise Montgomery-domain inverse of a batch (0 maps to 0).

    Each element takes its own Fermat chain, vectorised over the batch: the
    batch axis is the tensor's, so no sequential prefix product is needed."""
    return from_l16(inv16(spec, to_l16(a)))


# ---------------------------------------------------------------------------
# Bytes / ints <-> words, and the JAX package's limb arrays
# ---------------------------------------------------------------------------

def bytes_to_words(spec: FieldSpec, data) -> np.ndarray:
    """LE byte blob (N * n_bytes) -> (W, N) uint32 numpy words."""
    raw = (np.frombuffer(data, dtype=np.uint8)
           if isinstance(data, (bytes, bytearray, memoryview))
           else np.asarray(data, dtype=np.uint8))
    nb = spec.n_bytes
    if raw.size % nb:
        raise ValueError(f"byte length {raw.size} not a multiple of {nb}")
    return np.ascontiguousarray(raw.reshape(-1, nb).view("<u4").T)


def words_to_bytes(spec: FieldSpec, w) -> bytes:
    """(W, N) words (numpy or tensor) -> LE bytes."""
    if isinstance(w, torch.Tensor):
        w = w.cpu().numpy()
    return np.ascontiguousarray(np.asarray(w).view(np.uint32).T
                                ).astype("<u4").tobytes()


def words_tensor(w: np.ndarray, device=None) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor (bit pattern kept)."""
    w = np.ascontiguousarray(w, dtype=np.uint32)
    if not w.flags.writeable:            # a view of immutable bytes
        w = w.copy()
    return torch.from_numpy(w.view(np.int32)).to(device)


def bytes_to_tensor(spec: FieldSpec, data, device=None) -> torch.Tensor:
    """LE byte blob -> (W, N) int32 words on ``device``; the bytes go over
    as they are, (N, W), and the transpose runs on the device."""
    raw = np.frombuffer(data, dtype=np.uint8)
    W = n_words(spec)
    if raw.size % (4 * W):
        raise ValueError(f"byte length {raw.size} not a multiple of {4 * W}")
    rows = torch.from_numpy(raw.view("<i4").reshape(-1, W).copy())
    return rows.to(device).t().contiguous()


def tensor_to_bytes(w: torch.Tensor) -> bytes:
    """(W, N) int32 words -> LE bytes, transposed on the tensor's device."""
    return w.t().contiguous().cpu().numpy().astype("<i4", copy=False).tobytes()


def ints_to_words(spec: FieldSpec, values) -> np.ndarray:
    W = n_words(spec)
    out = np.zeros((W, len(values)), dtype=np.uint32)
    for j, v in enumerate(values):
        for i in range(W):
            out[i, j] = (v >> (32 * i)) & 0xFFFFFFFF
    return out


def words_to_ints(w) -> list:
    if isinstance(w, torch.Tensor):
        w = w.cpu().numpy()
    arr = np.asarray(w).view(np.uint32)
    if arr.ndim == 1:
        arr = arr[:, None]
    vals = [0] * arr.shape[1]
    for i in range(arr.shape[0]):
        for j, x in enumerate(arr[i].tolist()):
            vals[j] += x << (32 * i)
    return vals


def jax_limbs(spec: FieldSpec) -> int:
    """The JAX package's limb count for ``spec``: the least L with
    2^(15 L) >= 4096 p."""
    n = -(-spec.bits // JAX_LIMB_BITS)
    while (1 << (JAX_LIMB_BITS * n)) < 4096 * spec.modulus:
        n += 1
    return n


def from_jax_limbs(spec: FieldSpec, arr, device=None) -> torch.Tensor:
    """The JAX package's (L, N) 15-bit-limb Montgomery array (R = 2^(15L))
    -> the port's (W, N) words (R = 2^(8 n_bytes)), canonical."""
    a = np.asarray(arr, dtype=np.uint64)
    p = spec.modulus
    k = pow(1 << (JAX_LIMB_BITS * jax_limbs(spec)), -1, p) * radix(spec) % p
    vals = [0] * a.shape[1]
    for i in range(a.shape[0]):
        for j, x in enumerate(a[i].tolist()):
            vals[j] += int(x) << (JAX_LIMB_BITS * i)
    return words_tensor(ints_to_words(spec, [v * k % p for v in vals]), device)


def to_jax_limbs(spec: FieldSpec, w) -> np.ndarray:
    """Inverse of :func:`from_jax_limbs`: canonical 15-bit limbs, R_jax."""
    p, L = spec.modulus, jax_limbs(spec)
    k = pow(radix(spec), -1, p) * (1 << (JAX_LIMB_BITS * L)) % p
    vals = [v * k % p for v in words_to_ints(w)]
    out = np.zeros((L, len(vals)), dtype=np.uint32)
    mask = (1 << JAX_LIMB_BITS) - 1
    for j, v in enumerate(vals):
        for i in range(L):
            out[i, j] = (v >> (JAX_LIMB_BITS * i)) & mask
    return out
