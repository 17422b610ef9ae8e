"""BENCHMARK.json against the files it names and the contract's shapes."""

import json
import re

import pytest

from perfbench.harness import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell_name", CELLS)
def test_cell_files_exist(cell_name):
    entry = spec.cell(cell_name, BENCH)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4) and len(entry["why"]) <= 200
    traffic = spec.traffic(entry["traffic"])
    assert (spec.BENCH_DIR / "mixes" / f"{traffic['loop']}.py").exists()
    assert (spec.BENCH_DIR / "reference" / f"{entry['config']}.py").exists()
    assert spec.config(entry["config"], BENCH)
    limits = spec.limits(cell_name)
    assert limits, f"no limits for {cell_name}"
    assert all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("field", ["end_to_end", "per_layer"])
def test_metric_readers_and_names(field):
    for m in BENCH[field]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        for cell_name in m.get("workloads", []):
            assert cell_name in CELLS


def test_moves_target_is_reported_by_each_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell_name in m.get("workloads", CELLS):
            assert "workloads" not in target or cell_name in target["workloads"], (
                f"{m['name']} moves {target['name']}, which {cell_name} does not report")


def test_every_cell_reports_enough():
    for cell_name in CELLS:
        e2e = [m["name"] for m in spec.metrics_for(cell_name, "end_to_end", BENCH)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(cell_name, "per_layer", BENCH)


def test_configs_are_used_and_distinct():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert {c["name"] for c in BENCH["configs"]} == used
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        assert spec.load_json(spec.ROOT / c["file"])["reduced"] == c["reduced"]


def test_layers_of_one_name():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"window", "set-up", "sampler", "vag", "mlp model", "device",
                      "whole step"}
