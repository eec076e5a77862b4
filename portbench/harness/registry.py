"""Finds each part of a cell by the name ``BENCHMARK.json`` gives it: the
configuration file, the traffic file, the driver, the metric readers and the
limits of the output comparison. A later cell, configuration or metric is a
new file and a new entry; no file here names one."""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # portbench/
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> dict:
    """Everything a run of one workload needs, found by name: the workload
    entry, its configuration (file contents), its traffic mix, its limits,
    and the metrics it reports with and without a trace."""
    bench = bench or benchmark(root)
    wl = _by_name(bench["workloads"], name, "workload")
    cfg_entry = _by_name(bench["configs"], wl["config"], "config")
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())

    def reported(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {
        "workload": wl, "config": cfg, "traffic": traffic,
        "limits": json.loads((HERE / "limits" / f"{name}.json").read_text()),
        "end_to_end": reported(bench["end_to_end"]),
        "per_layer": reported(bench["per_layer"]),
    }


def load_file(path: Path, modname: str):
    """Import a Python file by path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def driver(kind: str):
    return load_file(HERE / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


def metric(name: str):
    return load_file(HERE / "metrics" / f"{name}.py",
                     "portbench_metric_" + name.replace(".", "_"))
