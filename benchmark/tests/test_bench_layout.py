"""BENCHMARK.json against the contract's shape, and every name in it found
as a file of its own."""

import json
import re
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(run.__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    res = run.resolve(SPEC, cell)
    assert run.loop(res["mix"]["loop"]).setup
    assert set(res["limits"]) and all(v > 0 for v in res["limits"].values())
    names = {m["name"] for m in res["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert res["per_layer"]


def test_names_units_and_readers():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(run.reader(m["name"]))
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", CELLS)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_files_and_cells():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used and c["file"].startswith("benchmark/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
