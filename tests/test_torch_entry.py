"""The port's entry points (``panda_tpu_torch.entry``) on the CPU: the
example inputs against ``__graft_entry__``'s, ``entry()``'s MSM against the
big-integer oracle, and the multi-rank dry run on four gloo ranks."""

import numpy as np
import torch

torch.set_num_threads(1)

import __graft_entry__ as jentry
from panda_tpu.curves.config import BN254 as JBN254
from panda_tpu_torch import entry
from panda_tpu_torch.curves.config import BN254
from panda_tpu_torch.fields import mont
from panda_tpu_torch.reference import curve_ref
from tests.jax_release import release_jax_programs  # noqa: F401


def test_example_inputs_match_jax_entry():
    """The same points and scalars as the JAX entry's, as port words."""
    px, py, s, pts, sv = entry._example_msm_inputs(BN254, 64, device="cpu")
    jpx, jpy, js, jpts, jsv = jentry._example_msm_inputs(JBN254, 64)
    assert (pts, sv) == (jpts, jsv)
    for got, spec, want in ((px, BN254.fp, jpx), (py, BN254.fp, jpy),
                            (s, BN254.fr, js)):
        assert torch.equal(got, mont.from_jax_limbs(spec, np.asarray(want)))


def test_entry_msm_matches_oracle():
    """entry()'s function is the BN254 MSM at c = window_bits(10) over
    (8, 2^10) example inputs; on the CPU (plain versions, ~30 s at 2^10)
    it is held to the oracle on the first 64 of them."""
    fn, args = entry.entry(device="cpu")
    assert [tuple(a.shape) for a in args] == [(8, 1 << 10)] * 3
    x, y, z = (mont.words_to_ints(a.reshape(-1, 1))[0]
               for a in fn(*(a[:, :64] for a in args)))
    p = BN254.fp.modulus
    zi = pow(z % p, -1, p)
    _, _, _, pts, sv = entry._example_msm_inputs(BN254, 1 << 10,
                                                 device="cpu")
    assert (x * zi % p, y * zi % p) == curve_ref.msm_oracle(BN254, pts[:64],
                                                            sv[:64])


def test_dryrun_multichip_four_ranks_on_cpu(capsys):
    entry.dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip(4): MSM n=64 (oracle ok) + NTT 2^8 " \
        "(bit-exact) OK" in capsys.readouterr().out
