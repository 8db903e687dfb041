"""The gather probe's row gather (``panda_tpu_torch.tools.profile_gather4``)
on the CPU against ``jnp.take`` on the same table and indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from panda_tpu_torch.tools import profile_gather4 as pg
from tests.jax_release import release_jax_programs  # noqa: F401


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
