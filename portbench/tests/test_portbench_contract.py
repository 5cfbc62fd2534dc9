"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file: names and units of the allowed characters, the keys of
each entry, the cells' files, each per-layer metric reported only where
the end-to-end metric it moves is."""

from __future__ import annotations

import json
import re

import pytest

from portbench.harness import PACKAGE, Registry

ROOT = PACKAGE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and 1 <= len(SPEC["command"]) <= 32
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its clock
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_have_the_contract_keys(group):
    for entry in SPEC[group]:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert KEYS[group] <= set(entry) <= KEYS[group] | extra, entry["name"]


def test_names_and_units_use_the_allowed_characters():
    names = []
    for group in KEYS:
        for entry in SPEC[group]:
            names.append(entry["name"])
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200, (entry["name"], key)
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    assert len(names) == len(set(names))


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_has_its_files_and_metrics():
    reg = Registry(ROOT / "BENCHMARK.json")
    configs = {c["name"]: c for c in SPEC["configs"]}
    used = set()
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4)
        used.add(w["config"])
        assert (ROOT / configs[w["config"]]["file"]).is_file()
        traffic = reg.data("traffic", w["traffic"])
        reg.find("traffic", traffic["kind"] + ".py")
        reg.find("kinds", traffic["kind"] + ".py")
        cell = reg.data("cells", w["name"])
        assert cell["limits"] and cell["precision"] in reg.data("configs", w["config"])["peaks_flops"]
        e2e = [m["name"] for m in reg.metrics_of(w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = reg.metrics_of(w["name"], "per_layer")
        assert layer
        for m in layer:
            reg.find("metrics", m["name"] + ".py")
            assert m["moves"] in e2e, (w["name"], m["name"])
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_config_files_hold_the_published_recipe():
    for c in SPEC["configs"]:
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"] == []
        assert body["train"]["model"]["depth_net"]["version"] == "1A"


def test_command_and_paths_stay_inside():
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.endswith("_torch")
