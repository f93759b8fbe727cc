"""BENCHMARK.json against the contract's forms, and every file it names."""

import json
import re

import pytest

from windbench.inputs import ROOT

BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    assert len(set(names)) == len(names)
    assert len({(w["config"], w["traffic"])
                for w in BENCH["workloads"]}) == len(BENCH["workloads"])


def test_units_lines_and_bounds():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    text = [w["why"] for w in BENCH["workloads"] + BENCH["configs"]]
    text += [m["layer"] for m in BENCH["per_layer"]]
    text += [c["source"] for c in BENCH["configs"]] + BENCH["command"]
    for t in text:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_its_files_and_metrics(w):
    assert (ROOT / "configs" / f"{w['config']}.json").is_file()
    traffic = ROOT / "traffic" / f"{w['traffic']}.json"
    kind = json.loads(traffic.read_text())["kind"]
    assert (ROOT / f"drive_{kind}.py").is_file()  # the mix's driver
    assert (ROOT / "limits" / f"{w['name']}.json").is_file()

    def mine(ms):
        return [m for m in ms if w["name"] in m.get("workloads",
                                                     [w["name"]])]
    e2e = {m["name"] for m in mine(BENCH["end_to_end"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    per = mine(BENCH["per_layer"])
    assert per and all(m["moves"] in e2e for m in per)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(m):
    assert (ROOT / "metrics" / f"{m['name']}.py").is_file()


def test_config_files_are_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert (ROOT.parent / c["file"]).is_file()
