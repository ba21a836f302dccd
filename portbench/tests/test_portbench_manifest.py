"""``BENCHMARK.json`` against the benchmark's contract, and every cell's
files found by name."""

import re

import pytest

from portbench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"end_to_end": {"name", "unit", "better", "bound", "source"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_the_manifest_has_the_contracts_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = 24  # the most a benchmark may hold
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_names_units_and_texts_use_the_allowed_characters():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and line(w["why"]) and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for group, keys in METRIC_KEYS.items():
        for m in BENCH[group]:
            assert set(m) - {"workloads"} == keys, m
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"])


def test_shares_of_a_roofline_or_peak_are_percentages():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_what_its_metrics_move(cell):
    e2e = harness.metric_entries(BENCH, cell, trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per_layer = harness.metric_entries(BENCH, cell, trace=True)
    assert per_layer
    for m in per_layer:
        assert m["moves"] in names, (m["name"], cell)
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in harness.metric_entries(BENCH, w, trace=False)}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cells_files_are_found_by_name(cell):
    c = harness.cell(BENCH, cell)
    driver = harness.driver(c.traffic["driver"])
    assert callable(driver.run)
    assert set(c.limits) and all(isinstance(v, (int, float)) for v in c.limits.values())
    for trace in (False, True):
        for m in harness.metric_entries(BENCH, cell, trace):
            assert callable(harness.reader(m["name"]))
    entry = next(e for e in BENCH["configs"] if e["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == cell))
    assert entry["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert c.config["name"] == entry["name"] and c.config["source"] == entry["source"]
    assert c.config["reduced"] == entry["reduced"]


def test_each_config_file_is_used_by_a_cell_and_is_no_other_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_every_layer_is_named_in_perf_md():
    perf = (harness.ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert m["layer"] in perf, m["layer"]
