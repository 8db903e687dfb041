"""Driver of the MSM entry with cached bases and fresh scalar bytes:
``api.msm_with_cached_bases`` or its alias ``msm_bn254_with_cached_bases``
(the mix's ``entry``).

Mix keys: ``callers``; ``base_sets`` (names from the configuration's
``base_sets``); ``vectors``, distinct scalar vectors; ``assign``: ``cycle``
(caller c's k-th call sends vector (c + callers k) mod vectors, so the
vectors in flight differ) or ``per_caller`` (caller c always sends vector
c mod vectors).  Base sets are taken in turn, k mod their count.
"""

from __future__ import annotations

from benchmark.core.msm_driver import FAMILY, MsmDriver  # noqa: F401


class Driver(MsmDriver):

    def __init__(self, ctx):
        super().__init__(ctx)
        self.assign = ctx.mix["assign"]
        if self.assign not in ("cycle", "per_caller"):
            raise ValueError(f"assign {self.assign!r}")

    def job(self, c: int, k: int) -> tuple:
        V = len(self.vectors)
        v = c % V if self.assign == "per_caller" else (c + self.callers * k) % V
        return self.key(k % len(self.sets), v), self.n

    def call(self, key: str) -> bytes:
        s, v = self.parse(key)
        return self.entry(self.gm, self.vectors[v].blob, s)
