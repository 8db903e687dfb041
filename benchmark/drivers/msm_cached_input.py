"""Driver of the MSM entry with cached scalars and cached bases:
``api.msm_with_cached_input`` or its alias ``msm_bn254_with_cached_input``
(the mix's ``entry``).

Set-up caches ``vectors`` scalar vectors in the session
(``init_msm_cached_scalars``) beside the base sets; no scalar bytes cross
in the window.  Caller c's k-th call takes base set (c + k) mod their
count and vector (c + k // base sets) mod ``vectors``.
"""

from __future__ import annotations

from benchmark.core.msm_driver import FAMILY, MsmDriver  # noqa: F401


class Driver(MsmDriver):

    def __init__(self, ctx):
        super().__init__(ctx)
        self.cached = [self.gm.init_msm_cached_scalars(v.blob)
                       for v in self.vectors]

    def job(self, c: int, k: int) -> tuple:
        S = len(self.sets)
        return self.key((c + k) % S, (c + k // S) % len(self.vectors)), self.n

    def call(self, key: str) -> bytes:
        s, v = self.parse(key)
        return self.entry(self.gm, self.cached[v], s)
