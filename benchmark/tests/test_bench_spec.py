"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re

import pytest

from benchmark import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRIC_KEYS = {"name", "unit", "better", "source"}
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.fullmatch(p) for p in BENCH["paths"])
    assert all(".." not in p.split("/") and not p.startswith("/") for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(text_ok(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("item", BENCH["configs"] + BENCH["workloads"] + ALL_METRICS,
                         ids=lambda d: d["name"])
def test_names(item):
    assert NAME.fullmatch(item["name"])
    for key in ("config", "traffic"):
        if key in item:
            assert NAME.fullmatch(item[key])
    for key in ("why", "layer", "source"):
        if key in item:
            assert text_ok(item[key])


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], ALL_METRICS):
        names = [d["name"] for d in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda d: d["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert (spec.ROOT / cfg["file"]).is_file()
    assert len(cfg["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
    assert sum(c["file"] == cfg["file"] for c in BENCH["configs"]) == 1


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda d: d["name"])
def test_workloads(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4)
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    cell = spec.load(w["name"], BENCH)  # every file the cell names is there
    assert cell.traffic["kind"] and cell.cell["limits"]
    pairs = [(x["config"], x["traffic"]) for x in BENCH["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", ALL_METRICS, ids=lambda d: d["name"])
def test_metric_fields(m):
    assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", [])) <= cells


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda d: d["name"])
def test_end_to_end(m):
    assert set(m) <= METRIC_KEYS | {"bound", "workloads"} and "bound" in m
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda d: d["name"])
def test_per_layer(m):
    assert set(m) <= METRIC_KEYS | {"layer", "moves", "workloads"}
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e and m["moves"] != "setup_s"
    # every cell that reports it reports the end-to-end metric it moves
    for cell in m.get("workloads", []):
        assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
    assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_one_layer_name_a_layer():
    """Metrics of one layer give the same `layer`; every layer name is one
    of PERF.md's."""
    perf = (spec.ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert m["layer"] in perf, m["layer"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda d: d["name"])
def test_every_cell_reports_enough(w):
    cell = spec.load(w["name"], BENCH)
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_setup_bound():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25


def test_check_cost_fits():
    """2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell to compile
    and 1200 s spare, at the full 24 cells, within 43200 s."""
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
