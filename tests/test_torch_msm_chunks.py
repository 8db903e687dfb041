"""The MSM's point chunks above ``msm.CHUNK_N`` (``ops/msm.py``): which
branch a size takes, and the columns each chunk reads.  Plain and mocked,
no JAX; the chunked path's bytes against the JAX package are in
``tests/test_torch_msm.py``."""

import pytest
import torch

from panda_tpu_torch.curves import point as cp
from panda_tpu_torch.curves.config import BN254
from panda_tpu_torch.curves.point import ProjPoint
from panda_tpu_torch.ops import msm
from tests.jax_release import release_jax_programs  # noqa: F401


def test_msm_above_chunk_n_takes_the_chunked_branch(monkeypatch):
    """n = 2^20 + 1 (the default CHUNK_N plus one) runs two chunks of 2^20
    points: the second takes the last 2^20 points with the digits of those
    the first took set to 0; their tables are summed with one add and
    reduced once (the phases are mocked: no real work)."""
    n = (1 << 20) + 1
    assert msm.CHUNK_N == 1 << 20
    digits = (torch.arange(n, dtype=torch.int32) % 7 + 1).reshape(1, n)
    px = torch.zeros((8, n), dtype=torch.int32)
    calls = []

    def tables(curve, cx, cy, d, s, c, m, wg, pts):
        calls.append((cx.shape, d.clone(), s.clone()))
        return cp.identity(curve, (1, 1 << (c - 1)))

    adds = []
    monkeypatch.setattr(msm, "_group_tables", tables)
    monkeypatch.setattr(msm.cp, "add", lambda curve, a, b: adds.append(1)
                        or a)
    monkeypatch.setattr(msm.red, "weighted_window_sum",
                        lambda curve, b: ProjPoint(*(a[..., 0] for a in b)))
    sums = msm.window_sums(BN254, px, px, digits, digits > 3, 16)
    assert [shape for shape, *_ in calls] == [(8, 1 << 20)] * 2
    assert torch.equal(calls[0][1], digits[:, :1 << 20])
    assert not calls[1][1][:, :-1].any() and not calls[1][2][:, :-1].any()
    assert calls[1][1][0, -1] == digits[0, -1]
    assert len(adds) == 1 and sums.x.shape == (8, 1)


@pytest.mark.parametrize("n, size", [(64, 16), (64, 24), (7, 3), (5, 5)])
def test_chunk_columns_cover_every_point_once(n, size):
    """The chunks' columns, contiguous and ``size`` wide, take every point
    once: a last chunk that would run past n reads the last ``size``
    columns with those an earlier chunk read set to 0."""
    a = torch.arange(1, 3 * n + 1, dtype=torch.int32).reshape(3, n)
    seen = torch.zeros_like(a)
    for lo in range(0, n, size):
        part = msm._chunk_columns(a, lo, size)
        assert part.shape == (3, size) and part.is_contiguous()
        at = min(lo, n - size)
        live = part != 0
        assert torch.equal(part[live], a[:, at:at + size][live])
        seen[:, at:at + size] += live.int()
    assert bool((seen == 1).all())
