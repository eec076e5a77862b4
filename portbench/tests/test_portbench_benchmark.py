"""BENCHMARK.json against the benchmark's contract: its keys, names, units
and bounds, and that every name finds its file."""

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LAYERS = {"facade", "FLAC lanes", "engine", "lane DSP", "kernels", "device"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_every_name_and_unit_uses_the_allowed_characters():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    bad = [n for n in names if not NAME.match(n)]
    assert not bad
    units = [m["unit"] for key in ("end_to_end", "per_layer") for m in BENCH[key]]
    assert all(UNIT.match(u) for u in units)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH[key]]
        assert len(got) == len(set(got)), key


@pytest.mark.parametrize("key, allowed", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries_have_just_the_contracts_keys(key, allowed):
    for e in BENCH[key]:
        assert set(e) <= allowed, e["name"]
        for text in ("why", "layer", "source"):
            if text in e and key != "end_to_end" and key != "per_layer":
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_metrics_and_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"realtime_x", "tick_ms_p90", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["layer"] in LAYERS and m["moves"] == "realtime_x"
        assert set(m.get("workloads", cells)) <= cells
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert reported and any(m["name"] != "setup_s" for m in BENCH["end_to_end"])


def test_every_name_finds_its_file():
    pb = ROOT / "portbench"
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (pb / "drivers" / f"{cfg['driver']}.py").is_file()
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert (pb / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((pb / "limits" / f"{w['name']}.json").read_text())["limits"]
        assert set(limits) == {"lsb_max", "off_ppm", "state_off", "carry_err"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (pb / "metrics" / f"{m['name']}.py").is_file()
