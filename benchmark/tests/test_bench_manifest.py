"""BENCHMARK.json against the benchmark's contract, and the files that each
of its names leads to."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_keys_and_sizes():
    assert set(MAN) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["benchmark"]
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word
    assert 1 <= len(MAN["configs"]) <= 24
    assert 1 <= len(MAN["workloads"]) <= 24


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200
                    assert "\n" not in e[key] and "\t" not in e[key]
    assert len(names) == len(set(names))
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in MAN["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_metrics_report_what_they_move():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = [w["name"] for w in MAN["workloads"]]
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved), m["name"]
    for cell in cells:
        reports = [m["name"] for m in MAN["end_to_end"]
                   if cell in m.get("workloads", cells)]
        assert "setup_s" in reports and len(reports) >= 2, cell
        assert any(cell in m["workloads"] for m in MAN["per_layer"]), cell


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files(w):
    conf = {c["name"]: c for c in MAN["configs"]}[w["config"]]
    assert (ROOT / conf["file"]).is_file()
    wl = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
    assert wl["traffic"] == w["traffic"]
    assert (BENCH / "traffic" / f"{w['traffic']}.py").is_file()
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_each_metric_has_its_reader(m):
    path = BENCH / "metrics" / f"{m['name']}.py"
    tree = ast.parse(path.read_text())
    lists = [n.value for n in tree.body if isinstance(n, ast.Assign)
             and any(getattr(t, "id", "") == "WORKLOADS" for t in n.targets)]
    assert lists and ast.literal_eval(lists[0]) == m["workloads"]
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
               or isinstance(n, ast.ImportFrom)
               and any(a.name == "read" for a in n.names)
               for n in tree.body)
