"""BENCHMARK.json's form, the files it names, and a cell added by new files
alone."""

import hashlib
import json
import shutil

import pytest

from benchmark.core import harness, spec


def test_benchmark_json_is_sound():
    bench = spec.load()
    assert spec.problems(bench) == []
    assert len(json.dumps(bench)) < 64 * 1024
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])            # every file found by name
        assert cell.chips == 1
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m.moves in names


@pytest.mark.parametrize("name,ok", [
    ("msm_points_per_s", True), ("device_idle_share.msm", True),
    ("bn254-groth16-2p20.witness-msm", True), ("_x", True), ("9lives", True),
    ("a b", False), ("a/b", False), ("a,b", False), ("-x", False),
    (".x", False), ("µs", False), ("x" * 65, False), ("", False)])
def test_names(name, ok):
    assert bool(spec.NAME.fullmatch(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("points/s", True), ("%", True), ("ms", True), ("elements/s", True),
    ("us", True), ("µs", False), ("tokens per second", False),
    ("x" * 17, False), ("", False)])
def test_units(unit, ok):
    assert bool(spec.UNIT.fullmatch(unit)) is ok


def test_problems_are_found():
    bench = spec.load()
    bad = json.loads(json.dumps(bench))
    bad["workloads"][0]["name"] = "has space"
    bad["end_to_end"][0]["unit"] = "points per s"
    bad["end_to_end"][0]["bound"] = 0.5
    bad["per_layer"][0]["moves"] = "nothing"
    bad["per_layer"][1]["extra"] = 1
    bad["configs"][0]["why"] = "two\nlines"
    found = "\n".join(spec.problems(bad))
    for text in ("bad name 'has space'", "bad unit", "bound 0.5",
                 "moves 'nothing'", "keys ['extra']", "why not 1-200"):
        assert text in found


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*")) if p.is_file()
        and "__pycache__" not in p.parts}


def test_a_cell_from_new_files_only(tmp_path):
    """A throwaway configuration, mix and per-layer metric, added as new
    files and entries in a copy of the benchmark: the cell loads and runs
    (on the CPU, at a small size) and no file that was there changes."""
    root = spec.ROOT
    shutil.copytree(root / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())

    b = tmp_path / "benchmark"
    (b / "configs" / "tiny-bn254.json").write_text(json.dumps({
        "name": "tiny-bn254", "curve": "bn254", "log_n": 3,
        "base_sets": ["q"], "point_pool": 4,
        "reduced": []}))
    (b / "mixes" / "one-caller.json").write_text(json.dumps({
        "driver": "msm_cached_bases", "entry": "msm_bn254_with_cached_bases",
        "callers": 1, "base_sets": ["q"], "vectors": 2, "assign": "cycle"}))
    (b / "metrics" / "calls_in_window.py").write_text(
        "UNIT, SOURCE = 'calls', 'host_clock'\n"
        "LAYER, MOVES = 'harness', 'msm_points_per_s'\n"
        "def read(run):\n"
        "    return float(sum(1 for c in run.calls if run.w0 <= c.t0 < run.w1))\n")
    bench["configs"].append({
        "name": "tiny-bn254", "source": "https://example.org/tiny",
        "file": "benchmark/configs/tiny-bn254.json", "reduced": [],
        "why": "a throwaway configuration"})
    bench["workloads"].append({
        "name": "tiny-bn254.one-caller", "config": "tiny-bn254",
        "traffic": "one-caller", "chips": 1, "why": "a throwaway cell"})
    bench["end_to_end"][0]["workloads"].append("tiny-bn254.one-caller")
    bench["per_layer"].append({
        "name": "calls_in_window", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "harness",
        "moves": "msm_points_per_s", "workloads": ["tiny-bn254.one-caller"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    assert spec.problems(bench, tmp_path) == []
    cell = spec.cell("tiny-bn254.one-caller", tmp_path)
    assert [m.name for m in cell.per_layer] == ["calls_in_window"]
    out = harness.run("tiny-bn254.one-caller", 12, 2.0, False, device="cpu",
                      root=tmp_path)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"msm_points_per_s", "setup_s"}
    out = harness.run("tiny-bn254.one-caller", 13, 2.0, True, device="cpu",
                      root=tmp_path)
    assert out["correct"] is True and out["metrics"]["calls_in_window"][
        "value"] >= 1

    after = digest(tmp_path)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {"BENCHMARK.json"}   # entries added, files untouched
