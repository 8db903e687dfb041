"""BENCHMARK.json and the files it names, found by name.

* a configuration: the ``file`` of its entry (``benchmark/configs/<name>.json``);
* a traffic mix: ``benchmark/mixes/<traffic>.json``, which names its driver,
  ``benchmark/drivers/<driver>.py``;
* a metric: ``benchmark/metrics/<name>.py``, with its ``UNIT``, ``SOURCE``
  and, for a per-layer metric, ``LAYER`` and ``MOVES``, and ``read(run)``.

A new cell, mix, configuration or metric is new files and new entries; no
file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    read: object                      # read(run) -> float | None
    layer: str | None = None
    moves: str | None = None


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: str
    mix: dict
    driver: object                    # benchmark/drivers/<name>.py
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _module(path: Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{tag}_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def metric(root: Path, entry: dict) -> Metric:
    mod = _module(Path(root) / "benchmark" / "metrics" / f"{entry['name']}.py",
                  "metric")
    for key, attr in (("unit", "UNIT"), ("source", "SOURCE"),
                      ("layer", "LAYER"), ("moves", "MOVES")):
        if key in entry and getattr(mod, attr, None) != entry[key]:
            raise ValueError(f"metric {entry['name']}: {key} "
                             f"{getattr(mod, attr, None)!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    return Metric(entry["name"], entry["unit"], entry["better"],
                  entry["source"], mod.read, entry.get("layer"),
                  entry.get("moves"))


def cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = load(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "benchmark" / "mixes"
                      / f"{w['traffic']}.json").read_text())
    driver = _module(root / "benchmark" / "drivers" / f"{mix['driver']}.py",
                     "driver")
    return Cell(name, w["chips"], w["config"], config, w["traffic"], mix,
                driver,
                [metric(root, e) for e in bench["end_to_end"]
                 if applies(e, name)],
                [metric(root, e) for e in bench["per_layer"]
                 if applies(e, name)])


def _text(value, limit: int = 200) -> bool:
    return (isinstance(value, str) and 1 <= len(value) <= limit
            and "\n" not in value and "\t" not in value)


def problems(bench: dict, root: Path = ROOT) -> list:
    """What in ``bench`` breaks the benchmark's rules of form: keys, names,
    units, lengths and cross references.  Empty when it is sound."""
    out = []
    if set(bench) != TOP_KEYS:
        out.append(f"top-level keys {sorted(bench)}")
    names = {}
    for kind, keys in ENTRY_KEYS.items():
        for e in bench.get(kind, []):
            extra = set(e) - keys
            if extra:
                out.append(f"{kind} {e.get('name')}: keys {sorted(extra)}")
            n = e.get("name", "")
            if not NAME.fullmatch(n):
                out.append(f"{kind}: bad name {n!r}")
            if n in names.setdefault(kind, set()):
                out.append(f"{kind}: {n} twice")
            names[kind].add(n)
            text = ("why", "layer") + (("source",) if kind == "configs"
                                       else ())
            for key in text:
                if key in e and not _text(e[key]):
                    out.append(f"{kind} {n}: {key} not 1-200 chars on one "
                               "line")
            if "unit" in e and not UNIT.fullmatch(e["unit"]):
                out.append(f"{kind} {n}: bad unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                out.append(f"{kind} {n}: better {e['better']!r}")
            if kind in ("end_to_end", "per_layer") and \
                    e.get("source") not in SOURCES:
                out.append(f"{kind} {n}: source {e.get('source')!r}")
    metric_names = names.get("end_to_end", set()) | names.get("per_layer",
                                                               set())
    if len(metric_names) != len(names.get("end_to_end", set())) + \
            len(names.get("per_layer", set())):
        out.append("a metric name is both end-to-end and per-layer")
    for c in bench.get("configs", []):
        for k in c.get("reduced", []):
            if not NAME.fullmatch(k):
                out.append(f"config {c['name']}: bad reduced key {k!r}")
        if not (Path(root) / c.get("file", "")).is_file():
            out.append(f"config {c['name']}: no file {c.get('file')}")
    cells = set()
    for w in bench.get("workloads", []):
        for key in ("config", "traffic"):
            if not NAME.fullmatch(w.get(key, "")):
                out.append(f"workload {w.get('name')}: bad {key}")
        if w.get("config") not in names.get("configs", set()):
            out.append(f"workload {w.get('name')}: unknown config")
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w.get('name')}: chips {w.get('chips')}")
        pair = (w.get("config"), w.get("traffic"))
        if pair in cells:
            out.append(f"workload {w.get('name')}: {pair} twice")
        cells.add(pair)
    e2e = {e["name"]: e for e in bench.get("end_to_end", [])}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for e in bench.get("end_to_end", []):
        b = e.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            out.append(f"end_to_end {e['name']}: bound {b}")
        if e.get("source") not in ("host_clock", "device_trace"):
            out.append(f"end_to_end {e['name']}: source {e.get('source')}")
    all_cells = {w["name"] for w in bench.get("workloads", [])}
    for e in bench.get("per_layer", []):
        moves = e2e.get(e.get("moves"))
        if moves is None:
            out.append(f"per_layer {e['name']}: moves {e.get('moves')!r}")
            continue
        for w in e.get("workloads", sorted(all_cells)):
            if w not in all_cells:
                out.append(f"per_layer {e['name']}: unknown cell {w}")
            elif not applies(moves, w):
                out.append(f"per_layer {e['name']}: {w} does not report "
                           f"{moves['name']}")
    for w in all_cells:
        if not any(applies(e, w) for e in bench.get("end_to_end", [])
                   if e["name"] != "setup_s"):
            out.append(f"workload {w}: no end-to-end metric but setup_s")
        if not any(applies(e, w) for e in bench.get("per_layer", [])):
            out.append(f"workload {w}: no per-layer metric")
    return out
