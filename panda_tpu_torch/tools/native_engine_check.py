"""The native caller's check: the port of ``tools/native_engine_check.py``.

This process plays a native (non-Python) prover that links the port's
``libpanda_host.so`` (``interop/native.py``): it imports no torch, so it
never holds a CUDA context, and no jax and no ``panda_tpu`` module.  Its
sessions on execution target 1 start the port's engine worker, which is
then the only process of this check on the card, as with a Rust prover.
For BN254 and BLS12-381 it checks:

- on the engine target: the MSM at 2^log_n by cached bases index and
  cached scalars index, and by cached bases and fresh scalar bytes, both
  equal to the pool-aggregated big-integer oracle and to each other; NTT,
  INTT and the NTT with the root w^3 at 2^min(log_n, 12) equal to
  ``reference/ntt_ref``, the INTT returning the input bytes;
- on the host target: ``set_config(1)`` gives the projective blob of the
  oracle's point, ``device_count() == 1``, and :func:`native.ntt_host`
  equals the session's host NTT (and the oracle).

Run it on the card (the worker's device is ``cuda:0``, or the CPU with
``PANDA_WORKER_DEVICE=cpu``):

    python -m panda_tpu_torch.tools.native_engine_check [--log-n 16]

It prints one JSON line and exits 0 when every comparison holds.  For
each engine-target call the line holds the sha256 of its first blob and
the kernels the worker launched for it (``PANDA_WORKER_LAUNCHES``, into a
directory of the check's own), so that a caller can hold both to the same
call made through ``runtime.api``.  With the worker on the card it also
times ``REPS`` more calls of each MSM, each equal to the first, and holds
nvidia-smi's compute apps before the worker starts and while it lives.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import subprocess
import sys
import tempfile
import time

from ..curves.config import CURVES
from ..interop import native
from ..reference import curve_ref, ntt_ref

SEED = 20261018
POOL = 512          # distinct points: the oracle's cost is the pool's
NAMES = ("bn254", "bls12_381")
REPS = 3            # timed repeats of each engine-target MSM on the card


def msm_case(curve, log_n: int, oracle: bool = True) -> dict:
    """Pool-structured MSM inputs of 2^log_n points: up to ``POOL``
    distinct points (successive multiples of the generator) drawn at
    random, and full-range scalars; the bases and scalars blobs, and the
    oracle's affine point of the scalars summed a pool point."""
    fp, fr = curve.fp, curve.fr
    n = 1 << log_n
    rng = random.Random(SEED + log_n)
    pool, acc = [], None
    for _ in range(min(n, POOL)):
        acc = curve_ref.ec_add(curve, acc, (curve.gen_x, curve.gen_y))
        pool.append(acc)
    wire = [b"".join(fp.to_wire_int(v).to_bytes(fp.n_bytes, "little")
                     for v in pt) for pt in pool]
    pidx = [rng.randrange(len(pool)) for _ in range(n)]
    scalars = [rng.randrange(fr.modulus) for _ in range(n)]
    case = {"bases": b"".join(wire[i] for i in pidx),
            "scalars": b"".join(fr.to_wire_int(s).to_bytes(fr.n_bytes,
                                                           "little")
                                for s in scalars)}
    if oracle:
        agg = [0] * len(pool)
        for i, s in zip(pidx, scalars):
            agg[i] += s
        case["want"] = curve_ref.msm_oracle(curve, pool, agg)
    return case


def ntt_case(fr, log_n: int) -> dict:
    """2^log_n random canonical elements as wire bytes, and the wire bytes
    of the root w^3 (w the field's 2^log_n-th root)."""
    rng = random.Random(SEED - log_n)
    vals = [rng.randrange(fr.modulus) for _ in range(1 << log_n)]
    w3 = pow(fr.root_of_unity(log_n), 3, fr.modulus)
    return {"vals": vals, "w3": w3, "data": _wire(fr, vals),
            "omega": _wire(fr, [w3])}


def _wire(spec, vals) -> bytes:
    return b"".join(spec.to_wire_int(v).to_bytes(spec.n_bytes, "little")
                    for v in vals)


def _values(spec, blob: bytes) -> list:
    nb = spec.n_bytes
    return [spec.from_wire_int(int.from_bytes(blob[i:i + nb], "little"))
            for i in range(0, len(blob), nb)]


def affine(curve, blob: bytes, coord_type: int):
    """The affine point of an MSM blob: Jacobian (``coord_type`` 0) or
    projective (1); None for the identity."""
    p = curve.fp.modulus
    x, y, z = _values(curve.fp, blob)
    if z % p == 0:
        return None
    zi = pow(z, -1, p)
    ex, ey = (zi * zi, zi * zi * zi) if coord_type == 0 else (zi, zi)
    return (x * ex % p, y * ey % p)


def compute_apps() -> list:
    """nvidia-smi's compute apps, one line each."""
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()


class Report:
    """The checks so far, one dict each."""

    def __init__(self):
        self.checks = []

    def check(self, curve, name: str, ok, **extra) -> None:
        self.checks.append({"curve": curve.name, "name": name,
                            "ok": bool(ok), **extra})


def host_checks(curve, log_n: int, ntt_log_n: int, rep: Report) -> None:
    """The host target: the MSM in both coordinate types against the
    oracle, the device count, and ntt_host against the session's NTT."""
    case, nc = msm_case(curve, log_n), ntt_case(curve.fr, ntt_log_n)
    with native.NativeSession(curve) as s:
        rep.check(curve, "host device_count() == 1", s.device_count() == 1)
        bi = s.cache_bases(case["bases"])
        si = s.cache_scalars(case["scalars"])
        rep.check(curve, f"host msm 2^{log_n} Jacobian = oracle",
                  affine(curve, s.msm(si, bi), 0) == case["want"])
        s.set_config(1)
        rep.check(curve, f"host msm 2^{log_n} set_config(1) projective = "
                  "oracle", affine(curve, s.msm(si, bi), 1) == case["want"])
        for label, kw, want in (
                ("ntt", {}, ntt_ref.ntt_oracle(
                    curve.fr, nc["vals"], curve.fr.root_of_unity(ntt_log_n))),
                ("ntt_v1 w^3", {"omega": nc["omega"]},
                 ntt_ref.ntt_oracle(curve.fr, nc["vals"], nc["w3"]))):
            got = s.ntt(nc["data"], ntt_log_n, **kw)
            rep.check(curve, f"host {label} 2^{ntt_log_n}: ntt_host = "
                      "session = oracle",
                      native.ntt_host(curve, nc["data"], ntt_log_n, **kw)
                      == got and _values(curve.fr, got) == want)


def engine_checks(curve, log_n: int, ntt_log_n: int, launches_dir: str,
                  on_card: bool, rep: Report) -> dict:
    """The engine target: the MSM by cached indices and by cached bases
    with fresh scalars, NTT, INTT and ntt_v1; returns each call's worker
    launches and the sha256 of its first blob, the timed calls, the
    worker's start-and-ping seconds and, with the worker ``on_card``,
    ``REPS`` more timed MSM calls and nvidia-smi's compute apps before it
    and while it lives."""
    fr = curve.fr
    case, nc = msm_case(curve, log_n), ntt_case(fr, ntt_log_n)
    path = os.path.join(launches_dir, f"{curve.name}.json")
    os.environ["PANDA_WORKER_LAUNCHES"] = path

    def counts():
        with open(path) as f:
            return json.load(f)

    row = {"launches": {}, "sha256": {}, "ms": {}}
    if on_card:
        row["compute_apps"] = [compute_apps()]
    with native.NativeSession(curve) as s:
        s.set_execution_target(1)
        t0 = time.perf_counter()
        s.engine_warmup()
        row["warmup_s"] = time.perf_counter() - t0
        bi = s.cache_bases(case["bases"])
        si = s.cache_scalars(case["scalars"])

        def call(name, fn):
            c0 = counts()
            t0 = time.perf_counter()
            out = fn()
            row["ms"].setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            c1 = counts()
            if name not in row["launches"]:
                row["launches"][name] = {k: c1[k] - c0[k] for k in c1}
                row["sha256"][name] = hashlib.sha256(out).hexdigest()
            return out

        msm = {"msm_cached": lambda: s.msm(si, bi),
               "msm_fresh": lambda: s.msm(case["scalars"], bi)}
        first = {name: call(name, fn) for name, fn in msm.items()}
        for name in msm:
            rep.check(curve, f"engine {name} 2^{log_n} = oracle",
                      affine(curve, first[name], 0) == case["want"])
        rep.check(curve, "engine msm: fresh scalar bytes = cached",
                  first["msm_fresh"] == first["msm_cached"])
        repeats = [call(name, fn) for _ in range(REPS if on_card else 0)
                   for name, fn in msm.items()]
        rep.check(curve, f"engine msm: {len(repeats)} repeats = the first",
                  all(b == first["msm_cached"] for b in repeats))
        if on_card:
            row["compute_apps"].append(compute_apps())
        k = ntt_log_n
        y = call("ntt", lambda: s.ntt(nc["data"], k))
        rep.check(curve, f"engine ntt 2^{k} = ntt_ref", _values(fr, y) ==
                  ntt_ref.ntt_oracle(fr, nc["vals"], fr.root_of_unity(k)))
        rep.check(curve, f"engine intt 2^{k} returns the input bytes",
                  call("intt", lambda: s.ntt(y, k, inverse=True))
                  == nc["data"])
        v1 = call("ntt_v1", lambda: s.ntt(nc["data"], k, omega=nc["omega"]))
        rep.check(curve, f"engine ntt_v1 2^{k} (w^3) = ntt_ref",
                  _values(fr, v1) == ntt_ref.ntt_oracle(fr, nc["vals"],
                                                        nc["w3"]))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=16)
    log_n = ap.parse_args(argv).log_n
    ntt_log_n, host_log_n = min(log_n, 12), min(log_n, 10)
    device = os.environ.get("PANDA_WORKER_DEVICE") or "cuda:0"
    curves = [CURVES[name] for name in NAMES]
    rep = Report()
    t0 = time.perf_counter()
    for curve in curves:
        host_checks(curve, host_log_n, ntt_log_n, rep)
    with tempfile.TemporaryDirectory() as tmp:
        engine = {curve.name: engine_checks(
            curve, log_n, ntt_log_n, tmp, device.startswith("cuda"), rep)
            for curve in curves}
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("torch", "jax", "panda_tpu"))
    res = {"ok": all(c["ok"] for c in rep.checks) and not foreign,
           "log_n": log_n, "ntt_log_n": ntt_log_n, "host_log_n": host_log_n,
           "worker_device": device, "foreign_modules": foreign,
           "checks": rep.checks, "engine": engine,
           "seconds": time.perf_counter() - t0}
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
