"""What a run is asked to do, found by name: the workload's entry in
`BENCHMARK.json`, its configuration (`configs/<config>.json`), its traffic
mix (`traffic/<mix>.json`) and the readers of its per-layer metrics
(`metrics/<metric>.py`, each a `read(run)` function). Adding a cell, a
configuration, a mix or a metric adds files and entries; nothing here
changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Metric:
    name: str
    unit: str


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    config_path: str
    traffic_path: str
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)
    readers: Dict[str, Callable] = field(default_factory=dict)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """`metrics/<name>.py`'s `read` function."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no reader for per-layer metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(m: dict, cell: str) -> bool:
    return "workloads" not in m or cell in m["workloads"]


def cell(name: str, bench: dict | None = None, root: str = ROOT) -> Cell:
    """The workload `name` with its files loaded and its metrics listed."""
    bench = bench if bench is not None else benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_path = os.path.join(root, configs[w["config"]]["file"])
    traffic_path = os.path.join(root, "slambench", "traffic", f"{w['traffic']}.json")
    c = Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
             chips=int(w["chips"]), config=load_json(cfg_path),
             traffic=load_json(traffic_path), config_path=cfg_path,
             traffic_path=traffic_path)
    c.end_to_end = [Metric(m["name"], m["unit"]) for m in bench["end_to_end"]
                    if _applies(m, name)]
    c.per_layer = [Metric(m["name"], m["unit"]) for m in bench["per_layer"]
                   if _applies(m, name)]
    c.readers = {m.name: load_reader(m.name) for m in c.per_layer}
    return c
