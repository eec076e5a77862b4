"""A later change adds a cell, a configuration and a metric as new files and
new entries of BENCHMARK.json, editing no file that is there: in a copy of
the benchmark, the new cell runs (rehearsed on the CPU) and reports the new
metric, and every file of the copy but BENCHMARK.json is byte for byte the
original."""

import hashlib
import json
import shutil
import subprocess
import sys

from conftest import ROOT


def _hashes(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_configuration_and_metric_are_new_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "aukit_tpu_torch").symlink_to(ROOT / "aukit_tpu_torch")
    before = _hashes(tmp_path)
    pb = tmp_path / "portbench"

    cfg = json.loads((pb / "configs" / "dfpwm_speakers.json").read_text())
    cfg.update(name="dfpwm_speakers_small", lanes=4)
    (pb / "configs" / "dfpwm_speakers_small.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "uniform_48k.json").read_text())
    traffic.update(pool_chunks=8, check_lanes=4, warmup_ticks=1)
    (pb / "traffic" / "small_pool.json").write_text(json.dumps(traffic))
    (pb / "limits" / "dfpwm_speakers_small.small_pool.json").write_text(
        json.dumps({"limits": {"lsb_max": 0, "off_ppm": 0, "state_off": 0, "carry_err": 0}}))
    (pb / "metrics" / "ticks_timed.py").write_text(
        '"""ticks_timed: ticks in the window."""\n\n\n'
        'def read(run, trace, cell, device):\n    return len(run["ticks"])\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dfpwm_speakers_small", "source": "https://example.org",
                             "file": "portbench/configs/dfpwm_speakers_small.json",
                             "reduced": ["lanes"], "why": "a test's"})
    bench["workloads"].append({"name": "dfpwm_speakers_small.small_pool",
                               "config": "dfpwm_speakers_small", "traffic": "small_pool",
                               "chips": 1, "why": "a test's"})
    bench["end_to_end"].append({"name": "ticks_timed", "unit": "ticks", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["dfpwm_speakers_small.small_pool"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json, sys, time; sys.path.insert(0, '.');"
            "from portbench.harness import core, registry;"
            "spec = registry.cell('dfpwm_speakers_small.small_pool');"
            "r = core.execute(spec, 7, 0.0, False, 'cpu', time.perf_counter());"
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["metrics"]["ticks_timed"]["value"] >= 1
    after = _hashes(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
