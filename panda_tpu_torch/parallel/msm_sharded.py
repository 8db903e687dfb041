"""Sharded MSM over the ranks of a ``torch.distributed`` mesh.

Counterpart of ``panda_tpu/parallel/msm_sharded.py``, with the same three
decompositions:

* **points**: each rank holds a contiguous slice of the points and scalars
  (:func:`shard_inputs`), runs the single-device window pipeline on it
  (``ops/msm``: digits, hist, phase A, buckets and wscan on the card), and
  the ranks' (L, W) window sums are gathered and folded with complete adds
  (``curves.point.fold_sum``: ceil(log2 D) padd launches on the card);
* **windows**: every rank holds all points and computes the sums of its
  block of Wp / D windows, Wp the window count padded to a multiple of D
  with zero-digit windows (identity sums); the blocks are gathered;
* **2-D**: points on one axis, windows on the other; the fold runs over
  the points axis, then the window blocks are gathered over the windows
  axis.

Every rank ends with the replicated window sums and runs the Horner tail on
the host (``msm.host_horner``), so every rank returns the affine result.
PyTorch runs eagerly: the JAX package's ``*_jitted`` wrappers have no
counterpart, and each ``*_fn`` returns the function of the rank's inputs.
The results are point-equal to the single-device MSM: point addition is
associative and the window decomposition is per scalar.
"""

from __future__ import annotations

import torch

from ..curves import point as cp
from ..curves.config import CurveSpec
from ..curves.point import ProjPoint
from ..fields import mont
from ..ops import msm as msm_ops
from . import cluster
from .cluster import Mesh


def _fold(curve: CurveSpec, sums: ProjPoint, group) -> ProjPoint:
    """Gather (L, k) window sums over ``group`` and add them up: (L, k)."""
    gathered = (cluster.all_gather(a, group) for a in sums)   # (D, L, k)
    return cp.fold_sum(curve, ProjPoint(*(g.permute(1, 2, 0)
                                          for g in gathered)))


def _gather_blocks(sums: ProjPoint, group, W: int) -> ProjPoint:
    """Tiled gather of (L, k) window blocks over ``group``, in rank order:
    (L, D k) cut to the first W windows."""
    out = []
    for a in sums:
        g = cluster.all_gather(a, group)                          # (D, L, k)
        out.append(g.permute(1, 0, 2).reshape(a.shape[0], -1)[:, :W])
    return ProjPoint(*out)


def _window_block(curve: CurveSpec, scalars, c: int, Wp: int, k: int,
                  idx: int):
    """Signed digits of windows [idx k, (idx + 1) k) of the scalars, the
    windows past the real W all-zero digits."""
    mags, negs = msm_ops.signed_digit_arrays(curve.fr, scalars, c)
    W, n = mags.shape
    if Wp > W:
        mags = torch.cat([mags, mags.new_zeros((Wp - W, n))])
        negs = torch.cat([negs, negs.new_zeros((Wp - W, n))])
    return (mags[idx * k:(idx + 1) * k].contiguous(),
            negs[idx * k:(idx + 1) * k].contiguous())


def _horner(curve: CurveSpec, sums: ProjPoint, c: int):
    return msm_ops.host_horner(curve, ProjPoint(*(a.cpu() for a in sums)), c)


def _columns(mesh: Mesh, axis: str, arrays) -> tuple:
    """This rank's contiguous block of the last axis of each array, on the
    rank's device."""
    d, i = mesh.shape[axis], mesh.index(axis)
    out = []
    for a in arrays:
        n = a.shape[-1]
        if n % d:
            raise ValueError(f"{n} columns do not split over {d} ranks")
        per = n // d
        out.append(a[..., i * per:(i + 1) * per].to(mesh.device)
                   .contiguous())
    return tuple(out)


# ---------------------------------------------------------------------------
# Points sharding
# ---------------------------------------------------------------------------

def msm_sharded_fn(curve: CurveSpec, mesh: Mesh, axis: str, c: int):
    """(px, py, scalars) of this rank's points -> the replicated window
    sums of all points, (L, W) x3."""
    def run(px, py, scalars):
        mags, negs = msm_ops.signed_digit_arrays(curve.fr, scalars, c)
        sums = msm_ops.window_sums(curve, px, py, mags, negs, c)
        return _fold(curve, sums, mesh.group(axis))
    return run


def msm_sharded(curve: CurveSpec, mesh: Mesh, axis: str, c: int,
                px, py, scalars):
    """Points-sharded MSM: device window sums, then host Horner.  Returns
    the affine result as plain ints (x, y), or None (identity)."""
    return _horner(curve, msm_sharded_fn(curve, mesh, axis, c)(
        px, py, scalars), c)


def shard_inputs(mesh: Mesh, axis: str, *arrays):
    """This rank's contiguous columns of (L, N) arrays, N split evenly over
    the mesh axis, on the rank's device."""
    return _columns(mesh, axis, arrays)


# ---------------------------------------------------------------------------
# Window sharding
# ---------------------------------------------------------------------------

def msm_window_sharded_fn(curve: CurveSpec, mesh: Mesh, axis: str, c: int):
    """(px, py, scalars) of all points (every rank the same) -> the
    replicated window sums, each rank computing Wp / D of the Wp windows
    (W padded to a multiple of D with zero-digit windows)."""
    d = mesh.shape[axis]
    W = msm_ops.signed_window_count(curve.fr.bits, c)
    Wp = -(-W // d) * d

    def run(px, py, scalars):
        k = Wp // d
        mags, negs = _window_block(curve, scalars, c, Wp, k,
                                   mesh.index(axis))
        sums = msm_ops.window_sums(curve, px, py, mags, negs, c)   # (L, k)
        return _gather_blocks(sums, mesh.group(axis), W)
    return run


def msm_window_sharded(curve: CurveSpec, mesh: Mesh, axis: str, c: int,
                       px, py, scalars):
    """Window-sharded MSM: replicated inputs, windows split across the
    mesh, host Horner tail."""
    px, py, scalars = (a.to(mesh.device) for a in (px, py, scalars))
    return _horner(curve, msm_window_sharded_fn(curve, mesh, axis, c)(
        px, py, scalars), c)


# ---------------------------------------------------------------------------
# 2-D mesh: points x windows
# ---------------------------------------------------------------------------

def msm_sharded_2d_fn(curve: CurveSpec, mesh: Mesh, axes: tuple, c: int):
    """Points sharded on ``axes[0]``, windows on ``axes[1]``.  Rank (i, j)
    recodes its points, takes window block j and runs the window sums on
    that (Wp / dw windows x n / dp points) tile; the blocks are folded over
    the points axis, then gathered over the windows axis.  Each rank
    receives (dp - 1) k and (dw - 1) k window triples
    (:func:`comm_volume_2d`), whatever n."""
    pax, wax = axes
    dw = mesh.shape[wax]
    W = msm_ops.signed_window_count(curve.fr.bits, c)
    Wp = -(-W // dw) * dw

    def run(px, py, scalars):
        mags, negs = _window_block(curve, scalars, c, Wp, Wp // dw,
                                   mesh.index(wax))
        sums = msm_ops.window_sums(curve, px, py, mags, negs, c)   # (L, k)
        mine = _fold(curve, sums, mesh.group(pax))
        return _gather_blocks(mine, mesh.group(wax), W)
    return run


def comm_volume_2d(curve: CurveSpec, dp: int, dw: int, c: int) -> dict:
    """Bytes each rank receives in the 2-D MSM's two gathers, counted in
    the port's words (a window triple is 3 x n_words(fp) x 4 bytes: 96 for
    BN254); the window counts are the JAX package's."""
    W = msm_ops.signed_window_count(curve.fr.bits, c)
    Wp = -(-W // dw) * dw
    k = Wp // dw
    stack = 3 * mont.n_words(curve.fp) * 4
    return {
        "windows_total": W,
        "windows_padded": Wp,
        "windows_per_device": k,
        "points_allgather_recv_bytes": (dp - 1) * k * stack,
        "windows_allgather_recv_bytes": (dw - 1) * k * stack,
        "total_recv_bytes_per_device": (dp - 1) * k * stack
                                       + (dw - 1) * k * stack,
        "note": "window-sum stacks only; n-independent",
    }


def msm_sharded_2d(curve: CurveSpec, mesh: Mesh, axes: tuple, c: int,
                   px, py, scalars):
    """2-D sharded MSM (points x windows) + host Horner tail.  Inputs: this
    rank's points (:func:`shard_inputs_2d`)."""
    return _horner(curve, msm_sharded_2d_fn(curve, mesh, axes, c)(
        px, py, scalars), c)


def shard_inputs_2d(mesh: Mesh, pax: str, *arrays):
    """This rank's columns of (L, N) arrays: N split over the points axis
    ``pax``, the same columns on every rank of the other axes."""
    return _columns(mesh, pax, arrays)
