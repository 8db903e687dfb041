"""Number-theoretic transform over the scalar field.

Counterpart of ``panda_tpu/ops/ntt.py``: X[k] = sum_j x[j] w^(j k) with w a
primitive 2^log_n-th root of unity; the inverse uses w^-1 and scales by
n^-1.  Inputs are (W, n) words in the port's Montgomery form (any value
below 2^256); the output is canonical.

One engine: the four-step byte-digit plan (``ops/ntt_mxu.py``), for every
log_n (log_n <= 5 is a single leaf pass).  Every engine of the JAX package
returns the same canonical bytes, so its stagewise and radix-2 engines are
not needed for the result.
"""

from __future__ import annotations

import torch

from ..fields.config import FieldSpec
from . import ntt_mxu


class NttTables:
    """Per-(field, log_n, omega) tables.  The four-step plans (device
    tensors) are built on first use, once per (inverse, device); the
    inverse's n^-1 rides in its plan's top matrix."""

    def __init__(self, spec: FieldSpec, log_n: int, omega: int):
        self.spec = spec
        self.log_n = log_n
        self.omega = omega                        # forward root (plain int)
        self._plans: dict = {}

    def plan(self, inverse: bool, device) -> ntt_mxu.MxuNttPlan:
        key = (inverse, torch.device(device))
        if key not in self._plans:
            self._plans[key] = ntt_mxu.mxu_plan(
                self.spec, self.log_n, inverse, self.omega, device)
        return self._plans[key]


def make_tables(spec: FieldSpec, log_n: int,
                omega: int | None = None) -> NttTables:
    """Tables for size 2^log_n; ``omega`` (plain integer) defaults to the
    field's canonical 2^log_n-th root of unity."""
    if omega is None:
        omega = spec.root_of_unity(log_n)
    return NttTables(spec, log_n, omega)


def run_ntt(spec: FieldSpec, x: torch.Tensor, tables: NttTables,
            inverse: bool = False) -> torch.Tensor:
    """Forward (or inverse, with the n^-1 scale) NTT of (W, 2^log_n) words
    on their device; canonical output."""
    plan = tables.plan(inverse, x.device)
    return ntt_mxu.apply_ntt(plan, x, ntt_mxu.plan_tables(plan))
