"""BENCHMARK.json against its format rules, and every cell's files
found by name."""

import json
import os
import re

import pytest

from portbench import harness, inputs

MANIFEST = inputs.load_json(os.path.join(inputs.REPO, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT_KEYS = ("why", "layer", "source")


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\t" not in s and "\n" not in s


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(inputs.REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)


def test_command_and_paths():
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(_text_ok(w) and not w.startswith("/") and ".." not in w for w in MANIFEST["command"])
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.endswith("_torch")
        assert os.path.isdir(os.path.join(inputs.REPO, p))


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(group):
    names = [e["name"] for e in MANIFEST[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for e in MANIFEST[group]:
        for k in TEXT_KEYS:
            if k in e:
                assert _text_ok(e[k]), (e["name"], k)


def test_metric_entries():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {c["name"] for c in MANIFEST["workloads"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_cells():
    configs = {c["name"] for c in MANIFEST["configs"]}
    pairs = [(c["config"], c["traffic"]) for c in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    assert {c["config"] for c in MANIFEST["workloads"]} == configs
    four = sum(c["chips"] == 4 for c in MANIFEST["workloads"])
    assert all(c["chips"] in (1, 4) for c in MANIFEST["workloads"]) and four <= max(1, len(pairs) // 4)
    for c in MANIFEST["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(c["traffic"]) and NAME.match(c["config"])

        def applies(m):
            return "workloads" not in m or c["name"] in m["workloads"]

        e2e = [m["name"] for m in MANIFEST["end_to_end"] if applies(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(applies(m) and m["moves"] in e2e for m in MANIFEST["per_layer"])


def test_configs_state_their_cuts():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        cfg = inputs.load_json(inputs.repo_path(c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", [c["name"] for c in MANIFEST["workloads"]])
def test_every_cell_finds_its_files(cell):
    spec = next(c for c in MANIFEST["workloads"] if c["name"] == cell)
    config, mix = harness.load_cell(MANIFEST, spec)
    assert os.path.exists(inputs.repo_path(config["bank"]["committed"]))
    assert mix["loop"] in ("stream", "cycle")
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        reader = harness.load_module(os.path.join(inputs.ROOT, "metrics", f"{m['name']}.py"))
        assert callable(reader.read)


def test_traffic_files_are_data():
    tdir = os.path.join(inputs.ROOT, "traffic")
    for f in os.listdir(tdir):
        assert f.endswith((".json", ".jsonl", ".toml", ".txt", ".csv")), f
        json.load(open(os.path.join(tdir, f)))
