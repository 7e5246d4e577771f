"""The manifest (``BENCHMARK.json``) keeps to the benchmark's contract, and
every name in it has its file."""
from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH, ROOT

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E = {m["name"]: m for m in M["end_to_end"]}
CELLS = {w["name"]: w for w in M["workloads"]}


def applies(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32
    assert all(TEXT.match(w) for w in M["command"])
    assert M["paths"] == ["colorbench"]
    assert M["command"][1].startswith("colorbench/")


def test_names_and_units():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in M[k]]
    names += [w[k] for w in M["workloads"] for k in ("config", "traffic")]
    names += [r for c in M["configs"] for r in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for kind in ("end_to_end", "per_layer"):
        for m in M[kind]:
            assert UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in M[kind]]
        assert len(got) == len(set(got)), kind


def test_entries_have_just_their_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and TEXT.match(w["why"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert TEXT.match(m["layer"])
    assert E2E["setup_s"]["bound"] <= 0.25


def test_every_name_has_its_file():
    for c in M["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("colorbench/configs/")
        cfg = json.loads(path.read_text())
        assert path.stem == c["name"]
        for key in c["reduced"]:
            assert key in cfg and key in cfg["reduced"], key
    for w in M["workloads"]:
        assert w["config"] in {c["name"] for c in M["configs"]}
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for kind in ("end_to_end", "per_layer"):
        for m in M[kind]:
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_what_it_must(cell):
    e2e = [m["name"] for m in M["end_to_end"] if applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = [m for m in M["per_layer"] if applies(m, cell)]
    assert layers
    for m in layers:
        assert m["moves"] in e2e, (m["name"], cell)


def test_per_layer_names_its_cells_and_layers():
    for m in M["per_layer"]:
        assert m["moves"] in E2E
        for cell in m.get("workloads", []):
            assert cell in CELLS and applies(E2E[m["moves"]], cell)
    for m in M["end_to_end"]:
        assert all(c in CELLS for c in m.get("workloads", []))


def test_the_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
