"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.core import harness, spec

BENCH = spec.ROOT / "benchmark"
DRY_RUN = """
import json, sys, torch
torch.set_num_threads(2)
sys.path.insert(0, {root!r})
from benchmark.core import harness
for cell, kw in [("bls12-377-zprize-2p24.batch4", dict(log_n=3)),
                 ("bn254-groth16-2p20.witness-msm", dict(log_n=3))]:
    out = harness.run(cell, 3, 2.5, False, device="cpu",
                      mix={{"callers": 1}}, **kw)
    assert out["correct"], out
print(json.dumps({{"forbidden": harness.forbidden_modules(),
                  "program": "panda_tpu_torch" in sys.modules}}))
"""


def top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_a_dry_run_loads_no_jax(tmp_path):
    """A CPU run of two cells' set-up and calls at a small size, in a fresh
    process: no module whose top-level name is jax, jaxlib, flax or
    panda_tpu (compared whole; panda_tpu_torch is loaded)."""
    res = subprocess.run([sys.executable, "-c",
                          DRY_RUN.format(root=str(spec.ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    line = res.stdout.strip().splitlines()[-1]
    assert line == '{"forbidden": [], "program": true}'


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "panda_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like.sub", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "panda_tpu.ops", object())
    assert harness.forbidden_modules() == ["panda_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert top_imports(path) <= {"__future__", "dataclasses", "numpy",
                                     "torch"}, path


def test_no_benchmark_file_imports_jax():
    for path in sorted(BENCH.rglob("*.py")):
        assert not top_imports(path) & set(harness.FORBIDDEN), path


CMD = ["--workload", "bn254-groth16-2p20.witness-msm", "--seed", "1", "--seconds",
       "1", "--trace", "0"]


def test_run_refuses_without_a_card():
    """``benchmark/run.py`` exits non-zero and prints no result where there
    is no CUDA card."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    res = subprocess.run([sys.executable, str(BENCH / "run.py"), *CMD],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""


def test_run_refuses_in_a_checkout_of_only_the_benchmark(tmp_path):
    """... and where the directory holds only BENCHMARK.json and the files
    under its paths."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = subprocess.run([sys.executable, "benchmark/run.py", *CMD],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert res.returncode != 0 and res.stdout == ""
