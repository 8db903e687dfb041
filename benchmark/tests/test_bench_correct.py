"""What decides ``correct``: whole runs of each mix on the CPU at a small
size (the harness but its look for a card), sound, with the control in the
program's place, and with the timed path broken underneath in each way a
cell of this benchmark can be."""

import pytest
import torch

from benchmark.core import harness
from panda_tpu_torch.runtime import api

MSM_CELLS = {"bls12-377-zprize-2p24.batch4": "msm_with_cached_bases",
             "bn254-groth16-2p20.witness-msm": "msm_bn254_with_cached_input"}
SMALL = {"log_n": 3, "mix": {"callers": 2}}


def run(cell, seed, **kw):
    return harness.run(cell, seed, 2.0, False, device="cpu",
                       **{**SMALL, **kw})


@pytest.mark.parametrize("cell", MSM_CELLS)
def test_sound_run_is_correct_and_the_control_is_not(cell):
    out = run(cell, 2**31 + 5, control=True)
    assert out["correct"] is True
    assert out["checks"]["wrong"]["value"] == 0
    assert out["checks"]["checked"]["value"] >= 2
    assert out["control"]["correct"] is False
    assert out["control"]["checks"]["wrong"]["value"] == \
        out["checks"]["checked"]["value"]
    assert list(out)[-1] == "checks"


def stale(real):
    """A call that returns the answer of the call before it: a step that
    leaves its state as it was."""
    last = []

    def call(*a, **k):
        out = real(*a, **k)
        if last:
            return last[0]
        last.append(out)
        return out
    return call


def altered(real):
    """An answer altered where it is produced: one byte of it."""
    def call(*a, **k):
        out = bytearray(real(*a, **k))
        out[len(out) // 3] ^= 0x5A
        return bytes(out)
    return call


def half_msm(real):
    """Half of the batch left out: the MSM's second half of scalars read as
    zero underneath the entry point (``api._msm_run``)."""
    def run_(gm, scalars, bases_xy, pts=None):
        s = scalars.clone()
        s[:, s.shape[1] // 2:] = 0
        return real(gm, s, bases_xy, pts)
    return run_


@pytest.mark.parametrize("fault", ["stale", "altered", "half"])
@pytest.mark.parametrize("cell", MSM_CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    if fault == "half":
        monkeypatch.setattr(api, "_msm_run", half_msm(api._msm_run))
    else:
        wrap = {"stale": stale, "altered": altered}[fault]
        monkeypatch.setattr(api, MSM_CELLS[cell],
                            wrap(getattr(api, MSM_CELLS[cell])))
    out = run(cell, 41)
    assert out["correct"] is False
    assert out["checks"]["wrong"]["value"] >= 1


def test_a_raising_call_is_not_correct(monkeypatch):
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) > 8:            # past the warm-up's call a base set
            raise RuntimeError("lost the device")
        return real(*a, **k)
    real = api.msm_bn254_with_cached_input
    monkeypatch.setattr(api, "msm_bn254_with_cached_input", flaky)
    out = run("bn254-groth16-2p20.witness-msm", 43)
    assert out["correct"] is False
    assert out["checks"]["failed"]["value"] >= 1
    assert out["failed"] >= 1


def test_traced_run_reads_the_program_spans():
    out = harness.run("bls12-377-zprize-2p24.batch4", 44, 0.5, True,
                      device="cpu", **SMALL)
    assert out["correct"] is True
    m = out["metrics"]
    assert m["horner_ms"]["value"] > 0
    assert "byte_api_self_ms.msm" in m
    # No card: the device metrics find nothing to read and are left out.
    assert "msm_kernel_ms" not in m and "msm_roofline_share" not in m
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert torch.get_num_threads() <= 2
