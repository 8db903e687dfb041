"""What the MSM drivers share: a session of the program holding every base
set of the configuration, the seed's scalar vectors, and the reference for
each key.

A key names what a call computes, ``<base set>/<vector>``; every call of a
key must return the same blob.
"""

from __future__ import annotations

from ..reference import curves
from ..reference import msm as msm_ref
from . import inputs

FAMILY = "msm"


class MsmDriver:
    """Set-up of an MSM cell: every base set of the configuration cached in
    one session of the program, as the deployment holds them, and the
    mix's ``vectors`` scalar vectors.  The calls use the mix's
    ``base_sets``."""

    def __init__(self, ctx):
        from panda_tpu_torch import InitUnitType, PandaManager
        from panda_tpu_torch.runtime import api
        cfg, mix = ctx.config, ctx.mix
        self.api, self.entry = api, getattr(api, mix["entry"])
        self.curve = curves.CURVES[cfg["curve"]]
        self.log_n = ctx.log_n
        self.n = 1 << self.log_n
        self.callers = mix["callers"]
        self.held = cfg["base_sets"]            # what the session holds
        self.sets = mix["base_sets"]            # what the calls use
        self.bases = [inputs.base_set(self.curve, self.log_n, ctx.seed, i,
                                      cfg["point_pool"])
                      for i in range(len(self.held))]
        self.vectors = [inputs.scalar_vector(self.curve, self.log_n,
                                             ctx.seed, v)
                        for v in range(mix["vectors"])]
        self.gm = PandaManager.init_all(
            0, InitUnitType.MSM, [b.blob for b in self.bases],
            curve=self.curve.name, device=ctx.device)
        for b in self.bases:
            b.blob = None                       # the session holds them now

    def key(self, s: int, v: int) -> str:
        return f"{self.sets[s]}/{v}"

    def parse(self, key: str) -> tuple:
        """(the base set's index in the session, the vector's index)."""
        name, v = key.split("/")
        return self.held.index(name), int(v)

    @property
    def keys(self) -> list:
        return [self.key(s, v) for s in range(len(self.sets))
                for v in range(len(self.vectors))]

    def warm(self) -> None:
        """One call a base set the session holds: each builds the set's
        point-major table."""
        for name in self.held:
            self.call(f"{name}/0")
        self.gm.sync()

    def release(self) -> None:
        self.gm.deinit()
        self.gm = None

    def _blobs(self, keys, fn) -> dict:
        out = {}
        for key in keys:
            s, v = self.parse(key)
            b = self.bases[s]
            out[key] = fn(self.curve, b.logs, b.pidx, self.vectors[v].words)
        return out

    def expected(self, keys) -> dict:
        return self._blobs(keys, msm_ref.expected_blob)

    def control(self, keys) -> dict:
        return self._blobs(keys, msm_ref.control_blob)
