"""BENCHMARK.json keeps to the benchmark's contract, as far as a file can
show it: keys, names, lengths, bounds, the files it names, and a reader
for every metric whose UNIT, LAYER, SOURCE and MOVES agree with it."""

import json
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert all(_line(w) for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    cells = 24              # a later benchmark's most
    total = (2 + 14 * cells) * (bench["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert total <= 43200
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 65536


def test_configs(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert len(c["reduced"]) <= 16
        with open(os.path.join(REPO, c["file"])) as f:
            world = json.load(f)["world"]
        for key in c["reduced"]:            # a cut of the world's scale
            assert NAME.match(key) and key in world
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert os.path.exists(os.path.join(
            REPO, "portbench", "traffic", w["traffic"] + ".json"))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(names) // 4)


def test_metrics_have_readers(bench):
    from portbench.cell import metric_reader
    seen = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        r = metric_reader(m["name"])
        assert (r.UNIT, r.SOURCE) == (m["unit"], m["source"])
        cells = {w["name"] for w in bench["workloads"]}
        assert set(m.get("workloads", cells)) <= cells
        if m in bench["per_layer"]:
            assert set(m) - {"workloads"} == {
                "name", "unit", "better", "source", "layer", "moves"}
            assert r.LAYER == m["layer"] and _line(m["layer"])
            assert r.MOVES == m["moves"] in {
                e["name"] for e in bench["end_to_end"]} - {"setup_s"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in bench["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup


def test_every_cell_reports_enough(bench):
    from portbench.cell import load
    for w in bench["workloads"]:
        cell = load(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert {m["moves"] for m in cell.per_layer} <= e2e
