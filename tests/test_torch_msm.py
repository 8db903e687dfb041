"""The slice: the port's byte-level MSM API (plain versions on the CPU)
against the JAX package's on the same blobs, byte for byte, and against the
big-integer oracle.  One n = 64 shape, so the JAX pipeline compiles once.
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from panda_tpu.runtime import api as japi
from panda_tpu.runtime import manager as jmanager
from panda_tpu.runtime.errors import PandaError as JPandaError
from panda_tpu.runtime.errors import PandaRuntimeError as JPandaRuntimeError
from panda_tpu_torch import InitUnitType, PandaManager, ResultCoordinateType
from panda_tpu_torch.curves.config import BN254
from panda_tpu_torch.fields import mont
from panda_tpu_torch.reference import curve_ref
from panda_tpu_torch.runtime import api
from panda_tpu_torch.runtime.errors import PandaError, PandaRuntimeError

ROOT = Path(__file__).resolve().parent.parent
N = 64
FP, FR = BN254.fp, BN254.fr


def _blob(vals, spec):
    return b"".join(spec.to_wire_int(v).to_bytes(spec.n_bytes, "little")
                    for v in vals)


@pytest.fixture(scope="module")
def case():
    rng = random.Random(64)
    pts = [curve_ref.random_point(BN254, rng) for _ in range(N)]
    scalars = [rng.randrange(FR.modulus) for _ in range(N)]
    bases = b"".join(_blob(pt, FP) for pt in pts)
    jgm = jmanager.PandaManager.init_all(0, jmanager.InitUnitType.MSM,
                                         [bases])
    return {"pts": pts, "scalars": scalars, "bases": bases,
            "sblob": _blob(scalars, FR), "jgm": jgm,
            "exp": curve_ref.msm_oracle(BN254, pts, scalars)}


@pytest.fixture(scope="module")
def gm(case):
    return PandaManager.init_all(0, InitUnitType.MSM, [case["bases"]],
                                 device="cpu")


def _decode(blob):
    x, y, z = (FP.from_wire_int(int.from_bytes(blob[i * 32:(i + 1) * 32],
                                               "little")) for i in range(3))
    return None if z == 0 else (x * pow(z, -1, FP.modulus) % FP.modulus,
                                y * pow(z, -1, FP.modulus) % FP.modulus)


def test_cached_bases_blob_matches_jax_and_oracle(case, gm):
    blob = api.msm_bn254_with_cached_bases(gm, case["sblob"], 0)
    want = japi.msm_bn254_with_cached_bases(case["jgm"], case["sblob"], 0)
    assert blob == want
    assert _decode(blob) == case["exp"]


def test_projective_output_and_identity_blob(case, gm):
    case["jgm"].set_config(jmanager.ResultCoordinateType.PROJECTIVE)
    gm.set_config(ResultCoordinateType.PROJECTIVE)
    try:
        blob = api.msm_bn254_with_cached_bases(gm, case["sblob"], 0)
        assert blob == japi.msm_bn254_with_cached_bases(case["jgm"],
                                                        case["sblob"], 0)
        assert _decode(blob) == case["exp"]
        zeros = bytes(32 * N)
        ident = api.msm_bn254_with_cached_bases(gm, zeros, 0)
        assert ident == japi.msm_bn254_with_cached_bases(case["jgm"], zeros, 0)
        assert ident == _blob((0, 1, 0), FP)
    finally:
        gm.set_config(ResultCoordinateType.JACOBIAN)
        case["jgm"].set_config(jmanager.ResultCoordinateType.JACOBIAN)


def test_cached_variants_agree(case, gm):
    blob = api.msm_bn254(gm, case["sblob"], case["bases"])
    sidx = gm.init_msm_cached_scalars(case["sblob"])
    assert api.msm_bn254_with_cached_scalars(gm, case["bases"], sidx) == blob
    assert api.msm_bn254_with_cached_input(gm, sidx, 0) == blob
    assert _decode(blob) == case["exp"]


def test_session_state_carries_across(case, gm):
    """The JAX session's cached bases and scalars, converted with
    from_jax_limbs, are the port's, and run to the same blob."""
    jgm = case["jgm"]
    jx, jy = (np.asarray(a) for a in jgm.d_bases[0])
    px, py = (mont.from_jax_limbs(FP, a) for a in (jx, jy))
    assert torch.equal(px, gm.d_bases[0][0])
    assert torch.equal(py, gm.d_bases[0][1])
    np.testing.assert_array_equal(mont.to_jax_limbs(FP, px),
                                  mont.to_jax_limbs(FP, gm.d_bases[0][0]))
    jsidx = jgm.init_msm_cached_scalars(case["sblob"])
    ps = mont.from_jax_limbs(FR, np.asarray(jgm.d_scalars[jsidx]))
    assert torch.equal(ps, gm.ingest_scalars(case["sblob"]))
    other = PandaManager.new(0, device="cpu")
    other.d_bases.append((px, py))
    other.d_scalars.append(ps)
    assert api.msm_bn254_with_cached_input(other, 0, 0) == \
        api.msm_bn254_with_cached_bases(gm, case["sblob"], 0)


def test_error_codes(case, gm):
    with pytest.raises(PandaRuntimeError) as e:
        api.msm_with_cached_bases(gm, case["sblob"], 3)
    assert e.value.code == PandaError.INVALID_VALUE
    with pytest.raises(PandaRuntimeError) as e:
        api.msm_with_cached_input(gm, 5, 0)
    assert e.value.code == PandaError.INVALID_VALUE
    with pytest.raises(PandaRuntimeError) as e:
        api.msm(gm, case["sblob"][:2 * 32], case["bases"])
    assert e.value.code == PandaError.INVALID_CONFIGURATION
    with pytest.raises(PandaRuntimeError) as e:
        api.msm(gm, case["sblob"][:-1], case["bases"])
    assert e.value.code == PandaError.INVALID_CONFIGURATION
    with pytest.raises(PandaRuntimeError) as e:
        api.msm(gm, case["sblob"], case["bases"][:-3])
    assert e.value.code == PandaError.INVALID_CONFIGURATION
    with pytest.raises(PandaRuntimeError) as e:
        api.msm(gm, b"", b"")
    assert e.value.code == PandaError.INVALID_CONFIGURATION
    for kwargs in ({"device_id": 99}, {"device": "cuda:99"},
                   {"device": "meta"}):
        with pytest.raises(PandaRuntimeError) as e:
            PandaManager.new(**kwargs)
        assert e.value.code == PandaError.INVALID_DEVICE
    with pytest.raises(PandaRuntimeError) as e:
        api.msm_bn254(PandaManager.new(0, "bls12_377", device="cpu"),
                      case["sblob"], case["bases"])
    assert e.value.code == PandaError.UNSUPPORTED_CURVE
    # the same codes as the JAX package's, by name
    with pytest.raises(JPandaRuntimeError) as je:
        japi.msm(case["jgm"], case["sblob"][:-1], case["bases"])
    assert je.value.code.name == "INVALID_CONFIGURATION"
    assert [(c.name, int(c)) for c in PandaError] == \
        [(c.name, int(c)) for c in JPandaError]


def test_chunked_path_and_array_msm_match_jax_and_oracle(case, gm,
                                                        monkeypatch):
    """The byte API with CHUNK_N = 16 (4 chunks) and 24 (the last chunk
    padded with digit-0 points) gives the JAX package's blob for the same
    case and the oracle's, and its window sums are point-equal to the
    unchunked path's; msm.msm (window sums, then Horner with the point ops)
    gives one point whose blob is the same."""
    from panda_tpu_torch.curves import point as cp
    from panda_tpu_torch.ops import msm
    want = japi.msm_bn254_with_cached_bases(case["jgm"], case["sblob"], 0)
    c = msm.window_bits(6, bits=FR.bits)
    px, py = gm.d_bases[0]
    scalars = gm.ingest_scalars(case["sblob"])
    mags, negs = msm.signed_digit_arrays(FR, scalars, c)
    whole = msm.window_sums(BN254, px, py, mags, negs, c)
    for chunk_n in (16, 24):
        got = msm.window_sums(BN254, px, py, mags, negs, c, chunk_n=chunk_n)
        assert bool(cp.eq(BN254, got, whole).all()), chunk_n
        monkeypatch.setattr(msm, "CHUNK_N", chunk_n)
        blob = api.msm_bn254_with_cached_bases(gm, case["sblob"], 0)
        assert blob == want and _decode(blob) == case["exp"], chunk_n
    monkeypatch.undo()
    q = msm.msm(BN254, px, py, scalars)
    assert q.x.shape == (8,)
    rinv = pow(mont.radix(FP), -1, FP.modulus)
    aff = None if bool(cp.is_identity(BN254, q)) else tuple(
        mont.words_to_ints(a)[0] * rinv % FP.modulus
        for a in cp.to_affine(BN254, q))
    assert aff == case["exp"] and gm.format_affine_result(aff) == want


# Threads of one wave of phase A on the H100, as its builds report them
# (phase_a.resident_threads; chip_smoke.py logs them): 132 SMs x 4 blocks
# of 128 for BN254 and x 3 for the BLS curves.
H100_PHASE_A_WAVE = {"bn254": 132 * 128 * 4, "bls12_377": 132 * 128 * 3,
                     "bls12_381": 132 * 128 * 3}


def test_phase_a_geometry_for_the_h100():
    """The H100 lane rule: every phase-A launch of the 2^16 and 2^20 MSMs
    runs in one wave of its curve's resident threads on the H100 and fills
    at least 3/4 of it, all 16 windows of 2^20 in one launch, the tests' n
    still give one lane per point, window_bits keeps its choices, and the
    plain version on the CPU takes CPU_THREADS."""
    from panda_tpu_torch.curves.config import BLS12_377, BLS12_381
    from panda_tpu_torch.ops import msm, phase_a
    assert (msm.window_bits(16), msm.window_bits(20)) == (13, 16)
    for curve in (BN254, BLS12_377, BLS12_381):
        assert phase_a.resident_threads(curve, torch.device("cpu")) == \
            phase_a.CPU_THREADS
        wave = H100_PHASE_A_WAVE[curve.name]
        for log_n in (16, 20):
            n = 1 << log_n
            W = msm.signed_window_count(curve.fr.bits, msm.window_bits(
                log_n, bits=curve.fr.bits))
            wg = msm._window_group_size(n, W)
            assert wg == W
            assert 3 * wave < 4 * wg * msm.default_lanes(n, wg, wave) <= \
                4 * wave
    for n in (48, 64):
        W = msm.signed_window_count(FR.bits, msm.window_bits(6))
        assert msm.default_lanes(n, W, phase_a.CPU_THREADS) == n == \
            msm._cost_model_lanes(n, W)


def test_occupancy_sweep_builds_change_the_source():
    """Each of the sweep's builds sets macros that its source reads with a
    default (so no build is silently the default one), each kernel's first
    build is the default, and the sweep needs a GPU."""
    import re
    from panda_tpu_torch.ops import _ext
    from panda_tpu_torch.tools import occupancy_sweep
    firsts = {}
    for name, defines in occupancy_sweep.BUILDS:
        firsts.setdefault(name, defines)
        text = (_ext.CSRC / f"{name}.cu").read_text()
        for d in defines:
            macro = re.fullmatch(r"-D(\w+)=\d+", d).group(1)
            assert f"#ifndef {macro}" in text, d
    assert firsts == {"phase_a": (), "wscan": (), "buckets": (),
                      "point_ops": (), "small_ntt": (), "dg3": ()}
    with pytest.raises(RuntimeError):
        occupancy_sweep.main()


def test_bucket_tables_do_not_depend_on_the_lane_count():
    """Phase A's geometry moves no bucket.  With the plain versions at
    n = 300, the steps per lane of the JAX lane rule and of the H100 rule at
    2^16 (S = 128 and 20: m = 3 and 15 here, both with padding) give equal
    bucket tables after affine normalisation, which hold the definition."""
    from panda_tpu_torch.curves import point as cp
    from panda_tpu_torch.ops import msm
    n, c = 300, 9
    W, D = msm.signed_window_count(FR.bits, c), 1 << (c - 1)
    rng = np.random.default_rng(300)
    mags = rng.integers(0, D + 1, size=(W, n))
    mags[:, :40] = 5                                   # one long run
    negs = rng.integers(0, 2, size=(W, n)).astype(bool)
    pool = [curve_ref.random_point(BN254, random.Random(s)) for s in range(24)]
    pts = [pool[i] for i in rng.integers(len(pool), size=n)]
    R = mont.radix(FP)
    px, py = (mont.words_tensor(mont.ints_to_words(
        FP, [v * R % FP.modulus for v in vals])) for vals in zip(*pts))
    d, s = torch.from_numpy(mags.astype(np.int32)), torch.from_numpy(negs)
    steps = [-(-(1 << 16) // m) for m in (msm._cost_model_lanes(1 << 16, 20),
                                          msm.default_lanes(
                                              1 << 16, 20,
                                              H100_PHASE_A_WAVE["bn254"]))]
    assert steps == [128, 20]
    old, new = (msm._bucket_tables(BN254, px, py, d, s, c, -(-n // S))
                for S in steps)
    assert bool(cp.eq(BN254, old, new).all())
    p = FP.modulus
    for w, b in ((0, 5), (3, 1), (W - 1, D)):
        acc = None
        for i in np.nonzero(mags[w] == b)[0]:
            acc = curve_ref.ec_add(BN254, acc, curve_ref.ec_neg(
                BN254, pts[i]) if negs[w, i] else pts[i])
        x, y, z = (mont.words_to_ints(a[:, w, b - 1].reshape(8, 1))[0]
                   for a in new)             # Montgomery factors cancel
        assert acc is not None and z % p
        assert (x * pow(z, -1, p) % p, y * pow(z, -1, p) % p) == acc


def test_wrappers_take_no_other_device():
    """A wrapper takes its plain version only for CPU tensors: any other
    device launches the kernel or raises, never falls back."""
    from panda_tpu_torch.ops import hist
    with pytest.raises(ValueError):
        hist.hist_counts(torch.zeros((1, 4), dtype=torch.int32,
                                     device="meta"), 3)


def _start(code_or_args, cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.Popen([sys.executable, *code_or_args], cwd=cwd,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(proc):
    out, err = proc.communicate(timeout=300)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _run(code_or_args, cwd):
    return _wait(_start(code_or_args, cwd))


FOREIGN = ("import sys\n"
           "print(sorted(m for m in sys.modules if m.split('.')[0] in "
           "('jax', 'panda_tpu')))\n")


def test_package_imports_without_jax():
    """The port loads neither jax nor any module of the JAX package."""
    res = _run(["-c", "import sys, panda_tpu_torch\n"
                "from panda_tpu_torch import PandaManager, BN254, PandaError\n"
                "from panda_tpu_torch.runtime import api, manager\n"
                "from panda_tpu_torch.ops import _ext, msm, ntt, reduce\n"
                "from panda_tpu_torch.curves import point\n"
                "from panda_tpu_torch.interop import native\n"
                "from panda_tpu_torch.utils import trace\n"
                "from panda_tpu_torch.reference import curve_ref, ntt_ref\n"
                "from panda_tpu_torch.tools import bounds, mul_rate, "
                "occupancy_sweep, point_api_times, profile_gather4\n"
                + FOREIGN], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_chip_smoke_imports_without_jax():
    """chip_smoke.py, imported without running main(), and every module it
    imports anywhere (its functions import lazily) load neither jax nor the
    JAX package."""
    res = _run(["-c", "import ast, importlib, sys\n"
                "sys.path.insert(0, '.')\n"
                "import chip_smoke\n"
                "tree = ast.parse(open('chip_smoke.py').read())\n"
                "mods = {n.module for n in ast.walk(tree)\n"
                "        if isinstance(n, ast.ImportFrom)}\n"
                "mods |= {a.name for n in ast.walk(tree)\n"
                "         if isinstance(n, ast.Import) for a in n.names}\n"
                "for m in sorted(mods):\n"
                "    if m.startswith('panda_tpu_torch'):\n"
                "        importlib.import_module(m)\n"
                "print(sorted(m for m in mods if m.split('.')[0] in "
                "('jax', 'panda_tpu')))\n" + FOREIGN], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["[]", "[]"]


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    procs = [_start([str(ROOT / "chip_smoke.py")], ROOT),       # both at once
             _start([str(alone)], tmp_path)]
    for res in map(_wait, procs):
        assert res.returncode != 0 and '"ok"' not in res.stdout
