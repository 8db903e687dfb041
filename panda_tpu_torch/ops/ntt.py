"""Number-theoretic transform over the scalar field.

Counterpart of ``panda_tpu/ops/ntt.py``: X[k] = sum_j x[j] w^(j k) with w a
primitive 2^log_n-th root of unity; the inverse uses w^-1 and scales by
n^-1.  Inputs are (W, n) words in the port's Montgomery form (any value
below 2^256); the output is canonical.

Two engines, both canonical and byte-equal, chosen as the JAX package's
``run_ntt`` chooses (``PANDA_NTT_IMPL``, read at call time):

* ``auto`` (the default) and ``mxu``: the four-step byte-digit plan
  (``ops/ntt_mxu.py``), for every log_n (log_n <= 5 is a single pass);
* ``pallas``: the radix-2 engine (``ops/ntt_pallas.py``) for
  log_n >= ``FUSED_MIN_LOG_N``; below it the JAX package runs its stagewise
  engine, which the port does not have, so the four-step plan runs;
* ``jnp``, the stagewise engine itself, raises ``NotImplementedError``.
"""

from __future__ import annotations

import os

import torch

from ..fields.config import FieldSpec
from . import ntt_mxu, ntt_pallas

FUSED_MIN_LOG_N = 10
IMPLS = ("auto", "mxu", "pallas", "jnp")


class NttTables:
    """Per-(field, log_n, omega) tables.  Each engine's plan (device
    tensors) is built on first use, once per (inverse, device); the
    inverse's n^-1 rides in its plan's top pass."""

    def __init__(self, spec: FieldSpec, log_n: int, omega: int):
        self.spec = spec
        self.log_n = log_n
        self.omega = omega                        # forward root (plain int)
        self._plans: dict = {}

    def plan(self, inverse: bool, device, engine: str = "mxu"):
        """The ``engine``'s plan: "mxu" (four-step) or "pallas" (radix-2)."""
        key = (engine, inverse, torch.device(device))
        if key not in self._plans:
            build = {"mxu": ntt_mxu.mxu_plan,
                     "pallas": ntt_pallas.fused_plan}[engine]
            self._plans[key] = build(self.spec, self.log_n, inverse,
                                     omega=self.omega, device=device)
        return self._plans[key]


def make_tables(spec: FieldSpec, log_n: int,
                omega: int | None = None) -> NttTables:
    """Tables for size 2^log_n; ``omega`` (plain integer) defaults to the
    field's canonical 2^log_n-th root of unity."""
    if omega is None:
        omega = spec.root_of_unity(log_n)
    return NttTables(spec, log_n, omega)


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
    if impl == "jnp":
        raise NotImplementedError(
            "PANDA_NTT_IMPL=jnp: the stagewise engine is not ported (ROADMAP "
            "queue 1, \"the stagewise NTT engine\")")
    if impl == "pallas" and tables.log_n >= FUSED_MIN_LOG_N:
        plan = tables.plan(inverse, x.device, "pallas")
        return ntt_pallas.fused_ntt(spec, x, tables.log_n, inverse, plan=plan)
    plan = tables.plan(inverse, x.device)
    return ntt_mxu.apply_ntt(plan, x, ntt_mxu.plan_tables(plan))
