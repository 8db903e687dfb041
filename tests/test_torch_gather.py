"""The gather probe (``panda_tpu_torch.tools.profile_gather4``) on the CPU:
``dg3``'s plain version against the JAX tool's Pallas kernel in interpret
mode, ``row_gather`` against ``jnp.take``, the wrapper's checks, the tool
itself at a small size, and its refusal to run without a GPU.  Outputs are
raw words and must be exactly equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

torch.set_num_threads(1)

from panda_tpu_torch.tools import profile_gather4 as pg

ROOT = Path(__file__).resolve().parent.parent


def _dg3_inputs(G, R, seed):
    rng = np.random.default_rng(seed)
    tab = rng.integers(1 << 31, size=(G, R, 128), dtype=np.int64)
    idx = rng.integers(R, size=(G, R, 128), dtype=np.int64)
    return tab.astype(np.int32), idx.astype(np.int32)


def _jax_dg3(tab, idx):
    """The JAX tool's kernel as it stands at tools/profile_gather4.py:78-83
    (local to its main(), so copied here), run in interpret mode."""
    G, R, _ = tab.shape
    spec = pl.BlockSpec((1, R, 128), lambda g: (g, 0, 0),
                        memory_space=pltpu.VMEM)

    def dg3(tab_ref, idx_ref, out_ref):
        out_ref[0] = jnp.take_along_axis(tab_ref[0], idx_ref[0], axis=0)

    fn = pl.pallas_call(
        dg3, grid=(G,), in_specs=[spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((G, R, 128), jnp.int32),
        interpret=True)
    return np.asarray(fn(jnp.asarray(tab), jnp.asarray(idx)))


@pytest.mark.parametrize("R", [8, 32])
@pytest.mark.parametrize("G", [2, 4])
def test_dg3_plain_matches_pallas_interpret(R, G):
    tab, idx = _dg3_inputs(G, R, 100 * R + G)
    want = _jax_dg3(tab, idx)
    got = pg.dg3_plain(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("R,dtype", [(9, np.uint32), (12, np.uint32),
                                     (16, np.uint32), (8, np.uint64)],
                         ids=["R9", "R12", "R16", "R8-u64"])
def test_row_gather_matches_jnp_take(R, dtype):
    """uint32 words go to the port as their int32 bit patterns, uint64 as
    int64 (values below 2^63, as the JAX tool draws them); JAX keeps 64-bit
    words only with x64 on."""
    n = 1 << 10
    rng = np.random.default_rng(R)
    top = 1 << (63 if dtype == np.uint64 else 32)
    tab = rng.integers(top, size=(n, R), dtype=np.uint64).astype(dtype)
    idx = rng.integers(n, size=(8, 8, 128), dtype=np.uint32)
    with jax.enable_x64(dtype == np.uint64):
        want = np.asarray(jax.jit(lambda p, i: jnp.take(p, i, axis=0))(
            jnp.asarray(tab), jnp.asarray(idx)))
    assert want.dtype == dtype
    signed = np.int64 if dtype == np.uint64 else np.int32
    got = pg.row_gather(torch.from_numpy(tab.view(signed)),
                        torch.from_numpy(idx.astype(np.int32)))
    assert got.shape == (8, 8, 128, R)
    np.testing.assert_array_equal(got.numpy(), want.view(signed))


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
