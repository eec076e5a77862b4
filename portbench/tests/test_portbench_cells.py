"""A tiny rehearsal of each cell on the CPU, the port's plain versions in
the kernels' place: the run's check finds the port's windows equal to the
plain reference's, and the control (the reference put in the program's
place, one precision below the configuration's) comes out not correct."""

import pytest
import torch

from conftest import rehearse

CELLS = ["dfpwm_speakers.uniform_48k", "dfpwm_speakers.mixed_rates",
         "dfpwm_speakers.lowpass", "radio_fleet.live_mixed"]


@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal_is_correct(workload):
    r = rehearse(workload, seconds=6.0 if workload.startswith("radio") else 0.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) >= {"realtime_x", "setup_s"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", ["dfpwm_speakers.lowpass", "radio_fleet.live_mixed"])
def test_control_is_not_correct(workload):
    from portbench.harness import registry

    kind = registry.cell(workload)["config"]["driver"]
    factory = registry.driver(kind).control(torch.int16, torch.bfloat16)
    r = rehearse(workload, seconds=0.0, factory=factory)
    assert not r["correct"], r["checks"]
    nums = {k: c["value"] for k, c in r["checks"].items()}
    assert nums["lsb_max"] > 8 and nums["state_off"] > 0
