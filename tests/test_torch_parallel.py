"""The sharded MSM and NTT (``panda_tpu_torch.parallel``) on four gloo ranks
on the CPU, against the big-integer oracle, the port's single-device
``msm.msm`` and ``run_ntt``, and the JAX package's sharded NTT.

One module fixture writes every case's inputs to files, starts the four
ranks once (``cluster.spawn`` of ``entry.sharded_cases``; the rank body
lives in the port, which imports no jax) and runs every case: a 4 x 1 mesh
for the points- and windows-sharded MSMs and the NTT, 2 x 2 for the 2-D
MSM.  The tests assert on the ranks' results.  The tiled all-to-all is
also held to a plain exchange of chunks in one process.  The JAX package's sharded MSMs compile for minutes on this CPU
and are not compared here; its sharded NTT is, at log_n = 8.
"""

import random

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

torch.set_num_threads(1)

from panda_tpu.curves.config import BN254 as JBN254
from panda_tpu.parallel import msm_sharded as jmsm_sharded
from panda_tpu.parallel import ntt_sharded as jntt_sharded
from panda_tpu_torch import entry
from panda_tpu_torch.curves import point as cp
from panda_tpu_torch.curves.config import BN254
from panda_tpu_torch.fields import mont
from panda_tpu_torch.ops import msm
from panda_tpu_torch.ops import ntt as ntt_ops
from panda_tpu_torch.parallel import cluster, msm_sharded, ntt_sharded
from panda_tpu_torch.reference import curve_ref
from tests.conftest import to_mont_limbs
from tests.jax_release import release_jax_programs  # noqa: F401

FR, FP = BN254.fr, BN254.fp
D = 4
MESH_1D = ((D,), ("d",))
MESH_2D = ((2, 2), ("points", "windows"))
# (mode, n, c): c = 5 gives W = 51, c = 6 W = 43, so the windows-sharded
# and 2-D cases run padded windows (Wp = 52 over 4 ranks, 52 / 44 over 2)
MSM_CASES = {"points": (64, 6), "windows": (32, 5), "2d": (32, 6)}
# forward, inverse, and forward with another primitive root, w^3
NTT_ROOTS = ((False, None), (True, None), (False, 3))
NTT_CASES = [(engine, log_n, inverse, power) for engine in ntt_sharded.ENGINES
             for log_n in (6, 8) for inverse, power in NTT_ROOTS]


def _blob(spec, vals) -> bytes:
    return b"".join(spec.to_wire_int(v).to_bytes(spec.n_bytes, "little")
                    for v in vals)


def _msm_inputs(n, seed):
    rng = random.Random(seed)
    pts = [curve_ref.random_point(BN254, rng) for _ in range(n)]
    scalars = [rng.randrange(FR.modulus) for _ in range(n)]
    return pts, scalars


def _root(log_n, power):
    return None if power is None else pow(FR.root_of_unity(log_n), power,
                                          FR.modulus)


def _ntt_values(log_n, seed):
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.integers(FR.modulus % (1 << 63),
                                         size=1 << log_n)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's inputs and the four ranks' results, case by case."""
    tmp = tmp_path_factory.mktemp("sharded")

    def file(name, blob):
        path = tmp / name
        path.write_bytes(blob)
        return str(path)

    cases, inputs = [], {}
    for mode, (n, c) in MSM_CASES.items():
        pts, scalars = _msm_inputs(n, n + c)
        inputs[mode] = (pts, scalars, c)
        cases.append({"op": "msm", "mode": mode, "curve": "bn254", "c": c,
                      "bases": file(f"{mode}.bases", b"".join(
                          _blob(FP, pt) for pt in pts)),
                      "scalars": file(f"{mode}.scalars", _blob(FR, scalars)),
                      "mesh": MESH_2D if mode == "2d" else MESH_1D})
    for log_n in (6, 8):
        data = file(f"ntt{log_n}", _blob(FR, _ntt_values(log_n, log_n)))
        for engine, lg, inverse, power in NTT_CASES:
            if lg == log_n:
                cases.append({"op": "ntt", "curve": "bn254", "log_n": log_n,
                              "inverse": inverse, "engine": engine,
                              "omega": _root(log_n, power), "data": data,
                              "mesh": MESH_1D})
    out = cluster.spawn(entry.sharded_cases, D, cases, backend="gloo",
                        device="cpu")
    return {"cases": cases, "inputs": inputs,
            "results": [[r[i] for r in out] for i in range(len(cases))]}


def _case(ranks, **match):
    for case, res in zip(ranks["cases"], ranks["results"]):
        if all(case.get(k) == v for k, v in match.items()):
            return case, res
    raise KeyError(match)


def _affine(pt) -> tuple | None:
    """One projective point of port words -> affine ints."""
    p = FP.modulus
    x, y, z = (mont.words_to_ints(a.reshape(-1, 1))[0] % p for a in pt)
    if z == 0:
        return None
    zi = pow(z, -1, p)
    return x * zi % p, y * zi % p


@pytest.mark.parametrize("mode", list(MSM_CASES))
def test_msm_sharded_matches_oracle_and_single_device(ranks, mode):
    """Every rank returns the oracle's point, which the port's single-device
    msm.msm (plain versions, same c) gives too."""
    pts, scalars, c = ranks["inputs"][mode]
    _, res = _case(ranks, op="msm", mode=mode)
    want = curve_ref.msm_oracle(BN254, pts, scalars)
    assert [r["result"] for r in res] == [want] * D
    px, py = (mont.words_tensor(mont.ints_to_words(
        FP, [FP.to_wire_int(v) for v in col])) for col in zip(*pts))
    s = mont.words_tensor(mont.ints_to_words(
        FR, [FR.to_wire_int(v) for v in scalars]))
    assert _affine(msm.msm(BN254, px, py, s, c=c)) == want


def test_padded_windows_are_zero_digits_with_identity_sums():
    """The windows-sharded cases pad W to Wp with zero-digit windows; a
    block of zero digits sums to the identity in every window."""
    for d, (n, c) in ((D, MSM_CASES["windows"]), (2, MSM_CASES["2d"])):
        W = msm.signed_window_count(FR.bits, c)
        assert -(-W // d) * d > W
    pts, _ = _msm_inputs(16, 1)
    px, py = (mont.words_tensor(mont.ints_to_words(
        FP, [FP.to_wire_int(v) for v in col])) for col in zip(*pts))
    zeros = torch.zeros((2, 16), dtype=torch.int32)
    sums = msm.window_sums(BN254, px, py, zeros, zeros.bool(), 5)
    assert cp.is_identity(BN254, sums).all()


def test_comm_volume_2d_windows_match_jax():
    """The window counts are the JAX package's; the bytes are the port's
    words: a window triple is 3 x 8 x 4 = 96 bytes for BN254."""
    for dp, dw, c in ((2, 4, 5), (2, 2, 6), (4, 2, 13), (1, 8, 16)):
        got = msm_sharded.comm_volume_2d(BN254, dp, dw, c)
        want = jmsm_sharded.comm_volume_2d(JBN254, dp, dw, c)
        for key in ("windows_total", "windows_padded", "windows_per_device"):
            assert got[key] == want[key]
        k = got["windows_per_device"]
        assert got["points_allgather_recv_bytes"] == (dp - 1) * k * 96
        assert got["windows_allgather_recv_bytes"] == (dw - 1) * k * 96
        assert got["total_recv_bytes_per_device"] == (dp + dw - 2) * k * 96


@pytest.mark.parametrize("engine", ntt_sharded.ENGINES)
@pytest.mark.parametrize("log_n", [6, 8])
def test_ntt_sharded_bytes_equal_single_device(ranks, engine, log_n):
    """Forward, inverse, and forward with the root w^3: the ranks' chunks,
    in rank order, are the single-device run_ntt's bytes (the same
    engine, the same root)."""
    for inverse, power in NTT_ROOTS:
        omega = _root(log_n, power)
        case, res = _case(ranks, op="ntt", engine=engine, log_n=log_n,
                          inverse=inverse, omega=omega)
        x = mont.bytes_to_tensor(FR, open(case["data"], "rb").read())
        want = ntt_ops.run_ntt(FR, x, ntt_ops.make_tables(FR, log_n, omega),
                               inverse, impl=engine)
        got = torch.cat([r["result"] for r in res], dim=1)
        assert mont.tensor_to_bytes(got) == mont.tensor_to_bytes(want)


def test_ntt_sharded_matches_jax(ranks):
    """log_n = 8, forward, mxu: the JAX package's sharded NTT on the
    conftest's 8-device CPU mesh, converted to the port's words."""
    devs = np.array(jax.devices())
    assert devs.size >= 8
    fn = jntt_sharded.ntt_sharded_jitted(JBN254.fr, Mesh(devs[:8], ("d",)),
                                         "d", 8)
    want = mont.from_jax_limbs(FR, np.asarray(fn(to_mont_limbs(
        JBN254.fr, _ntt_values(8, 8)))))
    _, res = _case(ranks, op="ntt", engine="mxu", log_n=8, inverse=False,
                   omega=None)
    assert torch.equal(torch.cat([r["result"] for r in res], dim=1), want)


def test_ntt_sharded_rejects_indivisible_sizes():
    mesh = cluster.Mesh(("d",), (4,), (0,), {"d": None},
                        torch.device("cpu"))
    for log_n in (2, 3):            # n1 = 2 < 4 ranks
        with pytest.raises(ValueError, match="divisible"):
            ntt_sharded.ntt_sharded_fn(FR, mesh, "d", log_n)
    with pytest.raises(ValueError, match="engine"):
        ntt_sharded.ntt_sharded_fn(FR, mesh, "d", 6, engine="pallas")


def test_all_to_all_is_the_tiled_transpose(monkeypatch):
    """cluster.all_to_all(t, split, concat): a global tensor sharded along
    ``concat`` comes back sharded along ``split`` (jax.lax.all_to_all with
    tiled=True), for both transposes the sharded NTT makes.  The D ranks
    run in turn in this process: all_to_all_single's exchange (chunk q of
    rank s's send is chunk s of rank q's receive) is done by hand."""
    g = torch.arange(2 * 16 * 8, dtype=torch.int32).reshape(2, 16, 8)
    monkeypatch.setattr(dist, "get_world_size", lambda group: D)
    for split, concat in ((2, 1), (1, 2)):
        local = g.chunk(D, dim=concat)
        sends = []
        monkeypatch.setattr(dist, "all_to_all_single",
                            lambda recv, send, group: sends.append(send))
        for t in local:
            cluster.all_to_all(t, split, concat, None)
        for r, t in enumerate(local):
            monkeypatch.setattr(
                dist, "all_to_all_single", lambda recv, send, group, r=r:
                recv.copy_(torch.stack([s[r] for s in sends])))
            got = cluster.all_to_all(t, split, concat, None)
            assert torch.equal(got, g.chunk(D, dim=split)[r])


def test_pod_mesh_spans_the_world_and_host_local_slice(ranks):
    """Rank r sits at d = r on the 1-D mesh and at (r // 2, r % 2) on the
    2 x 2 mesh; without a process group a process owns the whole axis."""
    _, res = _case(ranks, op="msm", mode="points")
    assert [r["coords"] for r in res] == [{"d": r} for r in range(D)]
    _, res = _case(ranks, op="msm", mode="2d")
    assert [r["coords"] for r in res] == [
        {"points": r // 2, "windows": r % 2} for r in range(D)]
    s = cluster.host_local_slice(100)
    assert (s.start, s.stop) == (0, 100)
