"""Number-theoretic transform over the scalar field.

Counterpart of ``panda_tpu/ops/ntt.py``: X[k] = sum_j x[j] w^(j k) with w a
primitive 2^log_n-th root of unity; the inverse uses w^-1 and scales by
n^-1.  Inputs are (W, n) words in the port's Montgomery form (any value
below 2^256); the output is canonical.

Three engines, all canonical and byte-equal, chosen as the JAX package's
``run_ntt`` chooses (``PANDA_NTT_IMPL``, read at call time):

* ``mxu``: the four-step byte-digit plan (``ops/ntt_mxu.py``) at every
  log_n (log_n <= 5 is a single pass);
* ``auto`` (the default): the four-step plan for log_n >=
  ``FUSED_MIN_LOG_N``, the stagewise engine below;
* ``pallas``: the radix-2 engine (``ops/ntt_pallas.py``) for log_n >=
  ``FUSED_MIN_LOG_N``, the stagewise engine below;
* ``jnp``: the stagewise engine at every log_n.

The stagewise engine (:func:`ntt`, :func:`intt`, the array-level API, any
batch dimensions) is the JAX package's: one gather into bit-reversed order,
then log_n radix-2 decimation-in-time stages over the whole array, each a
reshape, one twiddle product (the ``fmul`` kernel on a CUDA tensor) and the
field add and sub (``mont.add`` / ``mont.sub``, plain torch on the tensor's
device, as the JAX package leaves them to XLA).  The JAX package tracks
lazy 15-bit-limb bounds (``mont.FE``); here every value stays in [0, 2p),
or [0, p) for BLS12-381 Fr (``mont.canon``), so nothing is tracked.
``ntt_jitted`` has no counterpart: nothing is jitted.
"""

from __future__ import annotations

import os

import torch

from ..fields import mont
from ..fields.config import FieldSpec
from . import fmul as fmul_ops
from . import ntt_mxu, ntt_pallas

FUSED_MIN_LOG_N = 10
IMPLS = ("auto", "mxu", "pallas", "jnp")


def _power_table(spec: FieldSpec, omega: int, length: int,
                 device) -> torch.Tensor:
    """[w^0, ..., w^(length-1)] as canonical Montgomery words (W, length),
    built from Python big ints on the host, as the JAX package's
    ``_power_table``."""
    p = spec.modulus
    acc, vals = spec.to_wire_int(1), []
    for _ in range(length):
        vals.append(acc.to_bytes(spec.n_bytes, "little"))
        acc = acc * omega % p                     # (w^i R) w = w^(i+1) R
    return mont.words_tensor(mont.bytes_to_words(spec, b"".join(vals)),
                             device)


class NttTables:
    """Per-(field, log_n, omega) tables.  Each engine's plan (device
    tensors) is built on first use, once per (inverse, device); the
    inverse's n^-1 rides in its plan's top pass.  The stagewise engine's
    tables (``bitrev``, ``w_pows``, ``w_inv_pows``, ``n_inv``) are built on
    first use, once per device."""

    def __init__(self, spec: FieldSpec, log_n: int, omega: int):
        self.spec = spec
        self.log_n = log_n
        self.omega = omega                        # forward root (plain int)
        self._plans: dict = {}
        self._tables: dict = {}

    def plan(self, inverse: bool, device, engine: str = "mxu"):
        """The ``engine``'s plan: "mxu" (four-step) or "pallas" (radix-2)."""
        key = (engine, inverse, torch.device(device))
        if key not in self._plans:
            build = {"mxu": ntt_mxu.mxu_plan,
                     "pallas": ntt_pallas.fused_plan}[engine]
            self._plans[key] = build(self.spec, self.log_n, inverse,
                                     omega=self.omega, device=device)
        return self._plans[key]

    def _table(self, name: str, device, build) -> torch.Tensor:
        key = (name, torch.device(device))
        if key not in self._tables:
            self._tables[key] = build(device)
        return self._tables[key]

    def bitrev(self, device) -> torch.Tensor:
        """(n,) int64 bit-reversal permutation."""
        return self._table("bitrev", device, lambda d: torch.from_numpy(
            ntt_pallas._bitrev(self.log_n)).long().to(d))

    def w_pows(self, device) -> torch.Tensor:
        """(W, max(n/2, 1)) forward twiddles w^i, canonical words."""
        return self._table("w_pows", device, lambda d: _power_table(
            self.spec, self.omega, max((1 << self.log_n) // 2, 1), d))

    def w_inv_pows(self, device) -> torch.Tensor:
        """(W, max(n/2, 1)) inverse twiddles w^-i, canonical words."""
        return self._table("w_inv_pows", device, lambda d: _power_table(
            self.spec, pow(self.omega, -1, self.spec.modulus),
            max((1 << self.log_n) // 2, 1), d))

    def n_inv(self, device) -> torch.Tensor:
        """(W,) n^-1, canonical words."""
        spec = self.spec
        v = spec.to_wire_int(pow(1 << self.log_n, -1, spec.modulus))
        return self._table("n_inv", device, lambda d: mont.words_tensor(
            mont.ints_to_words(spec, [v]), d).reshape(-1))


def make_tables(spec: FieldSpec, log_n: int,
                omega: int | None = None) -> NttTables:
    """Tables for size 2^log_n; ``omega`` (plain integer) defaults to the
    field's canonical 2^log_n-th root of unity."""
    if omega is None:
        omega = spec.root_of_unity(log_n)
    return NttTables(spec, log_n, omega)


def _butterfly_stages(spec: FieldSpec, x: torch.Tensor, w_pows: torch.Tensor,
                      log_n: int) -> torch.Tensor:
    """log_n DIT stages over the last axis of (W, *batch, n) words in
    bit-reversed order (values below 2p, or p where ``mont.canon``); the
    same bounds come out.  Stage s pairs j and j + 2^s within blocks of
    2^(s+1) and multiplies the second by w^(t n / 2^(s+1)), t = j mod 2^s;
    stage 0's twiddle is 1 and is skipped."""
    n = 1 << log_n
    W, batch = x.shape[0], tuple(x.shape[1:-1])
    for s in range(log_n):
        m = 1 << s                       # half-size of each butterfly block
        g = n // (2 * m)                 # number of blocks
        xr = x.reshape((W,) + batch + (g, 2, m))
        u, v = xr[..., 0, :], xr[..., 1, :]
        if s:
            tw = w_pows[:, 0:n // 2:g].reshape((W,) + (1,) * (len(batch) + 1)
                                               + (m,))
            v = fmul_ops.fmul(spec, v.reshape(W, -1),
                              tw.expand(v.shape).reshape(W, -1)
                              ).reshape(v.shape)
        x = torch.stack((mont.add(spec, u, v), mont.sub(spec, u, v)),
                        dim=-2).reshape((W,) + batch + (n,))
    return x


def _finish(spec: FieldSpec, y: torch.Tensor,
            n_inv: torch.Tensor | None) -> torch.Tensor:
    """Transform tail: times n^-1 (``fmul``) for the inverse, canonical."""
    if n_inv is None:
        return mont.canonical(spec, y)
    W = y.shape[0]
    scale = n_inv.reshape(W, 1).expand(W, y[0].numel())
    return fmul_ops.fmul(spec, y.reshape(W, -1), scale,
                         canonical_out=True).reshape(y.shape)


def _stagewise(spec: FieldSpec, x: torch.Tensor, tables: NttTables,
               inverse: bool) -> torch.Tensor:
    dev = x.device
    x = mont.reduce_wire(spec, x).index_select(-1, tables.bitrev(dev))
    y = _butterfly_stages(spec, x, tables.w_inv_pows(dev) if inverse
                          else tables.w_pows(dev), tables.log_n)
    return _finish(spec, y, tables.n_inv(dev) if inverse else None)


def ntt(spec: FieldSpec, x: torch.Tensor, tables: NttTables) -> torch.Tensor:
    """Forward NTT along the last axis of (W, *batch, n) words (any values
    below 2^256) with the stagewise engine, on their device; canonical
    output."""
    return _stagewise(spec, x, tables, False)


def intt(spec: FieldSpec, x: torch.Tensor, tables: NttTables) -> torch.Tensor:
    """Inverse NTT along the last axis (includes the n^-1 scaling)."""
    return _stagewise(spec, x, tables, True)


def ntt_impl() -> str:
    """auto | mxu | pallas | jnp (``PANDA_NTT_IMPL``, default auto)."""
    return os.environ.get("PANDA_NTT_IMPL", "auto")


def run_ntt(spec: FieldSpec, x: torch.Tensor, tables: NttTables,
            inverse: bool = False, impl: str | None = None) -> torch.Tensor:
    """Forward (or inverse, with the n^-1 scale) NTT of (W, 2^log_n) words
    on their device; canonical output.  ``impl`` (default: read
    ``PANDA_NTT_IMPL`` now) picks the engine."""
    impl = ntt_impl() if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"PANDA_NTT_IMPL must be one of {IMPLS}, got "
                         f"{impl!r}")
    # A zero root takes the stagewise engine under every impl, as in the
    # JAX package's run_ntt.
    big = tables.log_n >= FUSED_MIN_LOG_N and tables.omega != 0
    if tables.omega and (impl == "mxu" or (impl == "auto" and big)):
        plan = tables.plan(inverse, x.device)
        return ntt_mxu.apply_ntt(plan, x, ntt_mxu.plan_tables(plan))
    if impl == "pallas" and big:
        plan = tables.plan(inverse, x.device, "pallas")
        return ntt_pallas.fused_ntt(spec, x, tables.log_n, inverse, plan=plan)
    return _stagewise(spec, x, tables, inverse)
