"""Entry points of the port: the single-device MSM step and the multi-rank
dry run.

Counterpart of ``__graft_entry__.py``.  :func:`entry` returns the flagship
step (the BN254 Pippenger MSM, ``ops.msm.msm``) with example inputs on the
card.  :func:`dryrun_multichip` starts ``n`` ranks and runs one step of the
sharded pipeline on small shapes: the points-sharded MSM against the
big-integer oracle, the 2-D points x windows MSM (n >= 4 and even), and the
four-step sharded NTT bit-exact against the single-device ``run_ntt``.

:func:`sharded_cases` is the rank body that the tests and ``chip_smoke.py``
start with ``parallel.cluster.spawn``: it runs a list of sharded MSM and
NTT cases whose inputs are files of wire bytes and returns each rank's
results, launch counts and times.
"""

from __future__ import annotations

import functools
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .curves.config import BN254, CURVES
from .fields import mont
from .ops import _ext
from .ops import msm as msm_ops
from .ops import ntt as ntt_ops
from .parallel import cluster, msm_sharded, ntt_sharded
from .reference import curve_ref
from .runtime.manager import PandaManager


def _device(device) -> torch.device:
    """The card (``cuda:0``) unless the caller names another device."""
    dev = torch.device(device if device is not None else "cuda:0")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return dev


def _example_msm_inputs(curve, n, seed=7, device=None):
    """Random on-curve points (small multiples of the generator) and random
    62-bit scalars, the JAX entry's draws from ``seed``, as the port's
    Montgomery words on ``device``: (px, py, scalars, pts, scalar ints)."""
    rng = np.random.default_rng(seed)
    fp, fr = curve.fp, curve.fr
    g, acc, table = (curve.gen_x, curve.gen_y), None, []
    for _ in range(16):
        acc = curve_ref.ec_add(curve, acc, g)
        table.append(acc)
    pts = [table[int(rng.integers(16))] for _ in range(n)]
    dev = _device(device)

    def words(spec, vals):
        return mont.words_tensor(mont.ints_to_words(
            spec, [spec.to_wire_int(v) for v in vals]), dev)

    sv = [int(rng.integers(1 << 62)) for _ in range(n)]
    return (words(fp, [x for x, _ in pts]), words(fp, [y for _, y in pts]),
            words(fr, sv), pts, sv)


def entry(device=None):
    """(fn, example_args): the BN254 MSM at n = 2^10 on the card (or on
    ``device``); ``fn(*args)`` returns one projective point."""
    n = 1 << 10
    c = msm_ops.window_bits(10)
    fn = functools.partial(msm_ops.msm, BN254, c=c)
    px, py, scalars, _, _ = _example_msm_inputs(BN254, n, device=device)
    return fn, (px, py, scalars)


def _example_ntt_input(log_n: int, device=None) -> torch.Tensor:
    """The JAX dry run's NTT input: 2^log_n values from seed 11."""
    fr = BN254.fr
    rng = np.random.default_rng(11)
    vals = [int(rng.integers(fr.modulus % (1 << 63)))
            for _ in range(1 << log_n)]
    return mont.words_tensor(mont.ints_to_words(
        fr, [fr.to_wire_int(v) for v in vals]), _device(device))


def _dryrun_rank(n_devices: int, n: int, c: int, log_n: int):
    """One rank of :func:`dryrun_multichip`: (MSM, 2-D MSM or None, this
    rank's NTT output chunk)."""
    mesh = cluster.pod_mesh("points")
    inputs = _example_msm_inputs(BN254, n, device="cpu")[:3]
    acc = msm_sharded.msm_sharded(
        BN254, mesh, "points", c,
        *msm_sharded.shard_inputs(mesh, "points", *inputs))
    acc2 = None
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2 = cluster.mesh((2, n_devices // 2), ("points", "windows"))
        acc2 = msm_sharded.msm_sharded_2d(
            BN254, mesh2, ("points", "windows"), c,
            *msm_sharded.shard_inputs_2d(mesh2, "points", *inputs))
    (xs,) = msm_sharded.shard_inputs(mesh, "points",
                                     _example_ntt_input(log_n, "cpu"))
    y = ntt_sharded.ntt_sharded_fn(BN254.fr, mesh, "points", log_n)(xs)
    return acc, acc2, y.cpu()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One step of the sharded pipeline on ``n_devices`` ranks that this
    call starts, each asserted against its reference.  The ranks run on the
    cards (``cuda:<rank mod device count>``) unless ``device="cpu"``: NCCL
    when there is a card for every rank, gloo otherwise (ranks sharing a
    card, or on the CPU)."""
    dev = _device(device)
    backend = ("nccl" if dev.type == "cuda"
               and torch.cuda.device_count() >= n_devices else "gloo")
    if dev.type == "cuda":
        _ext.build_all()              # once, before the ranks start
    n = max(64, 8 * n_devices)
    c = msm_ops.window_bits(max(n - 1, 1).bit_length())
    log_n = max(8, 2 * max(n_devices - 1, 1).bit_length())
    ranks = cluster.spawn(_dryrun_rank, n_devices, n_devices, n, c, log_n,
                          backend=backend, device=dev.type)

    _, _, _, pts, sv = _example_msm_inputs(BN254, n, device="cpu")
    want = curve_ref.msm_oracle(BN254, pts, sv)
    for r, (acc, acc2, _) in enumerate(ranks):
        if acc != want:
            raise AssertionError(f"rank {r}: sharded MSM != oracle: {acc} "
                                 f"vs {want}")
        if acc2 is not None and acc2 != want:
            raise AssertionError(f"rank {r}: 2-D sharded MSM != oracle: "
                                 f"{acc2} vs {want}")
    x = _example_ntt_input(log_n, dev)
    y1 = ntt_ops.run_ntt(BN254.fr, x, ntt_ops.make_tables(BN254.fr, log_n))
    y = torch.cat([chunk for _, _, chunk in ranks], dim=1)
    if not torch.equal(y, y1.cpu()):
        raise AssertionError("sharded NTT != single-device NTT")
    print(f"dryrun_multichip({n_devices}): MSM n={n} (oracle ok) + "
          f"NTT 2^{log_n} (bit-exact) OK")


# ---------------------------------------------------------------------------
# Sharded cases as one rank runs them
# ---------------------------------------------------------------------------

def _read(path, stride: int, part: int = 0, parts: int = 1) -> bytes:
    """Part ``part`` of ``parts`` equal parts (whole ``stride``-byte
    elements) of the file at ``path``, the only part read."""
    size = Path(path).stat().st_size
    if size % (stride * parts):
        raise ValueError(f"{size} bytes do not split into {parts} parts of "
                         f"{stride}-byte elements")
    with open(path, "rb") as f:
        f.seek(part * size // parts)
        return f.read(size // parts)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _case_fn(case: dict, mesh, dev: torch.device):
    """The case's call (no arguments) on this rank's inputs."""
    axes = case["mesh"][1]
    # this rank's contiguous part of the points or elements (all of them
    # for the windows-sharded MSM), the only part it reads
    curve = CURVES[case["curve"]]
    part = (0, 1) if case.get("mode") == "windows" else \
        (mesh.index(axes[0]), mesh.shape[axes[0]])
    if case["op"] == "ntt":
        fr = curve.fr
        xs = mont.bytes_to_tensor(fr, _read(case["data"], fr.n_bytes, *part),
                                  dev)
        fn = ntt_sharded.ntt_sharded_fn(
            fr, mesh, axes[0], case["log_n"], case.get("omega"),
            case.get("inverse", False), case.get("engine", "mxu"))
        return lambda: fn(xs)
    gm = PandaManager.new(0, curve, device=dev)
    inputs = (*gm.ingest_bases(_read(case["bases"], 2 * curve.fp.n_bytes,
                                      *part)),
              gm.ingest_scalars(_read(case["scalars"], curve.fr.n_bytes,
                                      *part)))
    fn = {"points": msm_sharded.msm_sharded,
          "windows": msm_sharded.msm_window_sharded,
          "2d": msm_sharded.msm_sharded_2d}[case["mode"]]
    return lambda: fn(curve, mesh, axes if case["mode"] == "2d"
                      else axes[0], case["c"], *inputs)


def sharded_cases(cases: list) -> list:
    """Run each case on this rank (every rank runs the same list).  A case
    is a dict: ``op`` "msm" (``mode`` "points", "windows" or "2d"; ``curve``
    name, ``c``, the paths of files of wire ``bases`` and ``scalars``) or
    "ntt" (``curve``, ``log_n``, the path of wire ``data``; ``inverse``,
    ``engine``, ``omega``); ``mesh`` (sizes, axis names), the first axis
    the one the points or rows are sharded on.  A rank reads only its own
    part of each input file.  With ``reps`` > 0 a warm call comes first,
    then the counted call, then ``reps`` timed calls.  Returns, a case: {"result": the MSM's affine
    point or the rank's output chunk, "launches": kernel launches of the
    counted call, "ms": wall ms of the timed calls, "coords": the rank's
    place in the case's mesh}."""
    dev = cluster.device()
    out = []
    for case in cases:
        mesh = cluster.mesh(*case["mesh"])
        call = _case_fn(case, mesh, dev)
        reps = case.get("reps", 0)
        if reps:
            call()
        _sync(dev)
        _ext.reset_counts()
        res = call()
        _sync(dev)
        counts = dict(_ext.launches)
        ms = []
        for _ in range(reps):
            dist.barrier()
            t0 = time.perf_counter()
            call()
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        if isinstance(res, torch.Tensor):
            res = res.cpu()
        out.append({"result": res, "launches": counts, "ms": ms,
                    "coords": mesh.coords})
    return out
