"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the cells
and the metrics.  A cell's configuration file is the one its entry names; its
traffic is ``perfbench/traffic/<traffic>.json``, whose ``loop`` names the
sampler loop ``perfbench/mixes/<loop>.py``; its limits are
``perfbench/limits/<cell>.json``; a metric's reader is
``perfbench/metrics/<metric>.py`` and a configuration's plain reference
``perfbench/reference/<config>.py``.  Adding any of them adds files and
entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: Optional[dict] = None) -> dict:
    """The ``workloads`` entry of the cell ``name``."""
    bench = bench if bench is not None else benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                   f"(cells: {[w['name'] for w in bench['workloads']]})")


def config(name: str, bench: Optional[dict] = None) -> dict:
    bench = bench if bench is not None else benchmark()
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell_name: str) -> Dict[str, float]:
    path = BENCH_DIR / "limits" / f"{cell_name}.json"
    return load_json(path)["limits"] if path.exists() else {}


def metrics_for(cell_name: str, field: str, bench: Optional[dict] = None) -> List[dict]:
    """The metrics of ``field`` ("end_to_end" or "per_layer") that the cell
    reports: those without a ``workloads`` key and those that list it."""
    bench = bench if bench is not None else benchmark()
    return [m for m in bench[field] if "workloads" not in m or cell_name in m["workloads"]]


def load_module(kind: str, name: str) -> ModuleType:
    """``perfbench/<kind>/<name>.py``, loaded by its path (names may hold
    ``-`` and ``.``) and kept in ``sys.modules`` under a name of its own."""
    key = f"perfbench_{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} module {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[key]
        raise
    return module
