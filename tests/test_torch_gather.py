"""The gather probe (``panda_tpu_torch.tools.profile_gather4``) on the CPU:
``dg3``'s plain version against the JAX tool's Pallas kernel in interpret
mode.  Outputs are raw words and must be exactly equal.  ``row_gather`` is
tested in ``test_torch_row_gather.py``, the wrapper's checks and the tool
itself in ``test_torch_gather_tool.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

torch.set_num_threads(1)

from panda_tpu_torch.tools import profile_gather4 as pg
from tests.jax_release import release_jax_programs  # noqa: F401


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
