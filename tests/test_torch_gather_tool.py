"""The gather probe (``panda_tpu_torch.tools.profile_gather4``) on the CPU:
the ``dg3`` wrapper's plain path and its checks, the tool itself at a small
size, and its refusal to run without a GPU.  Outputs are raw words and must
be exactly equal.  The plain versions against the JAX tool are in
``test_torch_gather.py`` and ``test_torch_row_gather.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from panda_tpu_torch.tools import profile_gather4 as pg
from tests.jax_release import release_jax_programs  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _dg3_inputs(G, R, seed):
    rng = np.random.default_rng(seed)
    tab = rng.integers(1 << 31, size=(G, R, 128), dtype=np.int64)
    idx = rng.integers(R, size=(G, R, 128), dtype=np.int64)
    return tab.astype(np.int32), idx.astype(np.int32)


@pytest.mark.parametrize("R", pg.DEPTHS)
def test_dg3_wrapper_on_cpu_is_plain(R):
    tab, idx = (torch.from_numpy(a) for a in _dg3_inputs(2, R, R))
    assert torch.equal(pg.dg3(tab, idx), pg.dg3_plain(tab, idx))


def test_dg3_rejects_bad_inputs():
    tab, idx = (torch.from_numpy(a) for a in _dg3_inputs(2, 8, 0))
    with pytest.raises(TypeError):
        pg.dg3(tab.long(), idx)
    with pytest.raises(TypeError):
        pg.dg3(tab, idx.long())
    with pytest.raises(ValueError):
        pg.dg3(tab.transpose(0, 1), idx.transpose(0, 1))
    with pytest.raises(ValueError):
        pg.dg3(tab, idx[:, :4].contiguous())
    with pytest.raises(ValueError):
        pg.dg3(tab[..., :64].contiguous(), idx[..., :64].contiguous())
    with pytest.raises(TypeError):
        pg.row_gather(tab[0], idx.long())


def test_tool_runs_every_case_on_cpu(capsys):
    rows = pg.main(torch.device("cpu"), n=1 << 10, ni=1 << 13,
                   lookups=1 << 13)
    lines = capsys.readouterr().out.splitlines()
    row_lines = [l for l in lines if l.startswith("HBM row gather")]
    dg3_lines = [l for l in lines if l.startswith("dg3 dynamic_gather")]
    assert [l.split(":")[0] for l in row_lines] == [
        "HBM row gather R=  9", "HBM row gather R= 12",
        "HBM row gather R= 16", "HBM row gather R=8 u64"]
    assert [int(l.split("R=")[1].split(":")[0]) for l in dg3_lines] == \
        list(pg.DEPTHS)
    assert all("host ms, cpu" in l for l in row_lines + dg3_lines)
    assert [(r["case"], r["R"]) for r in rows] == \
        [("row gather", R) for R in (9, 12, 16, 8)] + \
        [("dg3", R) for R in pg.DEPTHS]
    assert rows[2]["bytes"] == (1 << 10) * 64 + (1 << 13) * (4 + 64)
    assert rows[4]["lookups"] == 1 << 13 and rows[7]["lookups"] == 1024 * 128


def test_tool_raises_without_gpu():
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m",
                          "panda_tpu_torch.tools.profile_gather4"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "row gather" not in res.stdout
