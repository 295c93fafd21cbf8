"""Find a cell and everything it names, by name alone.

``BENCHMARK.json`` at the root lists the cells (``workloads``), the
configurations and the metrics.  A cell's configuration is the JSON file
its entry names, and the system it runs is ``systems/<system>.py`` for
the configuration's ``"system"``; its traffic mix is
``traffic/<traffic>.json``, driven by ``loops/<loop>.py`` for the mix's
``"loop"``; each metric it reports is read by ``metrics/<metric
name>.py``.  Adding a cell, a configuration, a mix, a loop, a system or a
per-layer metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, NamedTuple, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Metric(NamedTuple):
    name: str
    unit: str
    kind: str                      # "end_to_end" | "per_layer"
    read: Callable[[dict], Optional[float]]


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    system: ModuleType             # systems/<config's "system">.py
    loop: ModuleType               # loops/<mix's "loop">.py


class UnknownName(KeyError):
    pass


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(folder: str, name: str,
                bench_dir: Path = BENCH_DIR) -> ModuleType:
    """``<folder>/<name>.py``, loaded by its path (a name may hold dots
    and dashes)."""
    path = bench_dir / folder / f"{name}.py"
    if not path.is_file():
        raise UnknownName(f"no {folder}/{name}.py ({path})")
    key = f"portbench_{folder}_" + name.replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    # registered first: a dataclass looks its module up while it is made
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def load_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    return load_module("metrics", name, bench_dir).read


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, manifest: Optional[dict] = None,
              root: Path = ROOT) -> Cell:
    m = load_manifest(root) if manifest is None else manifest
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise UnknownName(f"unknown workload {name!r}; cells: "
                          f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in m["configs"]}
    if w["config"] not in configs:
        raise UnknownName(f"workload {name!r} names unknown config "
                          f"{w['config']!r}")
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    traffic_path = BENCH_DIR / "traffic" / f"{w['traffic']}.json"
    if not traffic_path.is_file():
        raise UnknownName(f"workload {name!r} names unknown traffic "
                          f"{w['traffic']!r} ({traffic_path})")
    with open(traffic_path) as f:
        traffic = json.load(f)

    def metrics(kind: str) -> List[Metric]:
        return [Metric(x["name"], x["unit"], kind, load_reader(x["name"]))
                for x in m[kind] if _reports(x, name)]

    return Cell(name, config, traffic, metrics("end_to_end"),
                metrics("per_layer"),
                load_module("systems", config["system"]),
                load_module("loops", traffic["loop"]))


def all_names(manifest: Optional[dict] = None) -> Dict[str, list]:
    m = load_manifest() if manifest is None else manifest
    return dict(workloads=[w["name"] for w in m["workloads"]],
                configs=[c["name"] for c in m["configs"]],
                traffic=sorted({w["traffic"] for w in m["workloads"]}),
                metrics=[x["name"] for k in ("end_to_end", "per_layer")
                         for x in m[k]])
