"""The port's trace utilities (``panda_tpu_torch/utils/trace.py``), the
twin of ``tests/test_trace.py``, and the byte API's phase labels, the JAX
API's five."""

import random

import torch

from panda_tpu_torch import BN254, InitUnitType, PandaManager
from panda_tpu_torch.reference import curve_ref
from panda_tpu_torch.runtime import api
from panda_tpu_torch.utils import trace
from tests.jax_release import release_jax_programs  # noqa: F401


def test_timer_records_and_prints(capsys, monkeypatch):
    monkeypatch.setenv("PANDA_PRINT_TRACE", "1")
    trace.reset()
    with trace.timer("unit: test phase", block=[torch.zeros((4,))]):
        pass
    out = capsys.readouterr().out
    assert "Start: unit: test phase" in out
    assert "End:   unit: test phase" in out
    s = trace.summary()
    assert s["unit: test phase"]["count"] == 1
    assert s["unit: test phase"]["total_s"] >= 0


def test_span_silent_by_default(capsys, monkeypatch):
    monkeypatch.delenv("PANDA_PRINT_TRACE", raising=False)
    trace.reset()
    t = trace.span("quiet phase")
    dt = t.end(block=torch.zeros((4,)))
    assert dt >= 0
    assert capsys.readouterr().out == ""
    assert trace.phase_times["quiet phase"] == [dt]


def test_api_records_phases(monkeypatch):
    """The byte API records the JAX API's labels: the NTT's three phases
    and the MSM's two."""
    monkeypatch.delenv("PANDA_PRINT_TRACE", raising=False)
    fr, fp = BN254.fr, BN254.fp
    rng = random.Random(3)
    trace.reset()
    gm = PandaManager.init_all(0, InitUnitType.NTT, device="cpu")
    vals = [rng.randrange(fr.modulus) for _ in range(8)]
    data = b"".join(fr.to_wire_int(v).to_bytes(32, "little") for v in vals)
    api.ntt_bn254(gm, data, 3)
    pts = [curve_ref.random_point(BN254, rng) for _ in range(4)]
    bases = b"".join(fp.to_wire_int(v).to_bytes(32, "little")
                     for pt in pts for v in pt)
    api.msm_bn254(gm, data[:4 * 32], bases)
    assert sorted(trace.summary()) == [
        "msm: horner (host)", "msm: window sums (device)",
        "ntt: d2h result", "ntt: execute", "ntt: h2d + domain shift"]
    assert all(v["count"] == 1 for v in trace.summary().values())


def test_profile_to_writes_a_trace(tmp_path):
    with trace.profile_to(str(tmp_path)):
        torch.ones(8).sum()
    assert list(tmp_path.glob("*.pt.trace.json"))
