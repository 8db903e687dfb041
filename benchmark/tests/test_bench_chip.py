"""On the card: a short run of each cell through ``benchmark/run.py``, and
the control at the cell's own size (``benchmark/control.py``).  Skips
where there is no CUDA card."""

import json
import subprocess
import sys

import pytest

from benchmark.core import spec

CELLS = [w["name"] for w in spec.load()["workloads"]]


def last_json(cmd):
    res = subprocess.run([sys.executable, *cmd], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=1500)
    assert res.returncode == 0, res.stderr[-3000:]
    return [json.loads(x) for x in res.stdout.strip().splitlines()
            if x.startswith("{")]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(card, cell):
    out = last_json(["benchmark/run.py", "--workload", cell, "--seed",
                     "2147483659", "--seconds", "3", "--trace", "0"])[-1]
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == card
    assert "setup_s" in out["metrics"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    for line in last_json(["benchmark/control.py", "--workload", cell,
                           "--seeds", "1", "2", "3", "--seconds", "3"]):
        assert line["correct"] is True
        assert line["control_correct"] is False
