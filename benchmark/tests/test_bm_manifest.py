"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re
from pathlib import Path

import pytest

from benchmark.harness import manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def m():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(m["command"]) <= 32 and all(_line(w)
                                                for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_fits_with_24_cells(m):
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries(m):
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in m["paths"]))
        names.append(c["name"])
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(
        1, len(m["workloads"]) // 4)
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in m["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(p["layer"])
    for metric in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher")
    every = ([c["name"] for c in m["configs"]]
             + [w["name"] for w in m["workloads"]]
             + [e["name"] for e in m["end_to_end"] + m["per_layer"]])
    assert len(set(every)) == len(every)


def test_every_config_has_a_cell_and_every_cell_a_config(m):
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}


def test_every_cell_reports_setup_another_e2e_and_a_layer(m):
    for w in m["workloads"]:
        cell = manifest.Cell(w["name"])
        e2e = {e["name"] for e in cell.e2e}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]


def test_every_layer_metric_moves_an_e2e_metric_its_cells_report(m):
    for p in m["per_layer"]:
        assert p["workloads"], p["name"]
        for cell_name in p["workloads"]:
            cell = manifest.Cell(cell_name)
            assert p["moves"] in {e["name"] for e in cell.e2e}, (
                p["name"], cell_name)
            reader = manifest.load_reader(p["name"])
            assert cell.kind_name in reader.KINDS, (p["name"], cell_name)


def test_every_file_a_cell_needs_is_found(m):
    for w in m["workloads"]:
        cell = manifest.Cell(w["name"])
        adapter = cell.adapter()
        assert adapter.KIND == cell.kind_name
        assert cell.adapter(control=True) is not None
        for p in cell.per_layer:
            reader = manifest.load_reader(p["name"])
            if hasattr(reader, "LAYER"):
                assert reader.LAYER in adapter.SPANS, (p["name"], w["name"])
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()


def test_every_traffic_kind_and_scene_family_is_found(m):
    from benchmark.harness import scenes
    for w in m["workloads"]:
        cell = manifest.Cell(w["name"])
        for attr in ("Loop", "UNIT", "NUMBERS", "outputs", "numbers",
                     "FAULTS"):
            assert hasattr(cell.kind, attr), (cell.kind_name, attr)
        kind = cell.config["scene"]["kind"]
        assert hasattr(scenes.load("scenes", kind), "make"), kind


def test_every_number_has_a_limit_between_its_readings(m):
    """Each number a cell compares has a limit above the program's largest
    reading (lower) and below the smallest of the control or of a fault
    (upper), with the readings it was set from."""
    for w in m["workloads"]:
        cell = manifest.Cell(w["name"])
        assert set(cell.limits) == set(cell.kind.NUMBERS), w["name"]
        for name, entry in cell.limits.items():
            assert entry["lower"] < entry["limit"] < entry["upper"], (
                w["name"], name)
            assert entry["upper"] >= 3 * entry["lower"], (w["name"], name)
            assert entry["from"], (w["name"], name)


def test_span_targets_exist_in_the_program(m):
    import importlib
    for w in m["workloads"]:
        for names in manifest.Cell(w["name"]).adapter().SPANS.values():
            for mod, attr in names:
                assert hasattr(importlib.import_module(mod), attr), (mod,
                                                                     attr)


def test_files_under_paths_are_named_from_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert all(NAME.match(part) for part in rel.split("/")), rel
