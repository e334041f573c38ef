"""`BENCHMARK.json` against the contract's names, units and files."""
import json
import re

import pytest

from smoke import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
M = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_paths():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["bench"] and 1 <= M["run_seconds"] <= 51
    assert M["command"][1] == "bench/run.py"
    assert all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) for p in M["paths"])


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_unique_and_allowed(group):
    names = [e["name"] for e in M[group]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for e in M[group]:
        for key in ("why", "layer", "source"):
            if key in e and group != "end_to_end" and group != "per_layer":
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_configs_and_cells_have_their_files():
    configs = {c["name"]: c for c in M["configs"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    used = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and w["config"] in configs
        assert (ROOT / "bench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "bench/checks" / f"{w['name']}.json").is_file()
        used.add(w["config"])
    assert used == set(configs)


def test_metrics_have_readers_units_and_moves():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = [w["name"] for w in M["workloads"]]
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "bench/metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for w in cells:  # each cell: setup_s, another end-to-end, a per-layer
        mine = [m for m in M["end_to_end"] if w in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(w in m["workloads"] for m in M["per_layer"])


def test_shares_of_a_peak_are_named_so():
    for m in M["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
