"""Host ms of the point API's calls on the card: calls that launch
point_ops many times on small batches, so that the host paces them.

    python -m panda_tpu_torch.tools.point_api_times [reps]

or, to time another checkout's package with this script (its own build),

    PYTHONPATH=<checkout> python3 panda_tpu_torch/tools/point_api_times.py

BN254, on the card: ``msm.horner`` over (8, 20) random window sums at
c = 13 (the 2^16 MSM's windows; 280 point_ops launches while a window's c
doublings took c launches, 40 since they take one), ``curves.point.fold_sum``
of 2^16 points (16 launches) and ``curves.point.scalar_mul`` of 2^16 points
by one full-width scalar (508).  One JSON line a call: the package's path,
point_ops launches a call, the median, least and most host ms over
``reps`` calls (each ending in a device synchronise, after one warm-up) and
a digest of the result's words, which two checkouts share when they return
the same words.  Raises without a GPU.
"""

from __future__ import annotations

import hashlib
import json
import random
import statistics
import sys
import time

import numpy as np
import torch

import panda_tpu_torch
from panda_tpu_torch.curves import point as cp
from panda_tpu_torch.curves.config import BN254
from panda_tpu_torch.curves.point import AffinePoint
from panda_tpu_torch.fields import mont
from panda_tpu_torch.ops import _ext, msm
from panda_tpu_torch.reference import curve_ref

WINDOWS, C = 20, 13


def _points(n: int, device, seed: int = 5):
    """(8, n) projective BN254 points drawn from 64 random ones."""
    fp, rng = BN254.fp, random.Random(seed)
    pool = [curve_ref.random_point(BN254, rng) for _ in range(64)]
    idx = torch.from_numpy(np.random.default_rng(seed).integers(
        64, size=n)).to(device)
    px, py = (mont.words_tensor(mont.ints_to_words(
        fp, [fp.to_wire_int(q[i]) for q in pool]), device)[:, idx]
        for i in (0, 1))
    return cp.from_affine(BN254, AffinePoint(px, py))


def main(reps: int = 20, device=None) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("point_api_times: no CUDA device")
    device = torch.device(device or "cuda:0")
    sums = _points(WINDOWS, device, 6)
    p = _points(1 << 16, device)
    k = random.Random(7).randrange(BN254.fr.modulus)
    kw = torch.from_numpy(mont.ints_to_words(BN254.fr, [k])[:, 0].view(
        np.int32))
    rows = []
    for name, run in (("horner", lambda: msm.horner(BN254, sums, C)),
                      ("fold_sum", lambda: cp.fold_sum(BN254, p)),
                      ("scalar_mul", lambda: cp.scalar_mul(BN254, p, kw))):
        got = run()
        before = _ext.launches["point_ops"]
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        digest = hashlib.sha256(b"".join(
            a.cpu().numpy().tobytes() for a in got)).hexdigest()[:16]
        row = {"package": panda_tpu_torch.__path__[0], "call": name,
               "launches": (_ext.launches["point_ops"] - before) // reps,
               "ms_median": statistics.median(ms), "ms_min": min(ms),
               "ms_max": max(ms), "reps": reps, "digest": digest}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    print(f"[point_api_times] {torch.cuda.get_device_name(0)}" if
          torch.cuda.is_available() else "", flush=True)
    main(*(int(a) for a in sys.argv[1:2]))
