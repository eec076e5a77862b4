"""What a run imports and where it runs: no module of the JAX package or of
JAX is loaded (top-level names compared whole, so ``aukit_tpu_torch``
passes), and a run without a card exits with another code than 0 and prints
no result."""

import json
import subprocess
import sys

from conftest import ROOT

REHEARSAL = f"""
import json, sys
sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})
from conftest import rehearse
r = rehearse("dfpwm_speakers.uniform_48k")
assert r["correct"], r
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_rehearsal_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", REHEARSAL], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "aukit_tpu_torch" in tops and "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "aukit_tpu"}


def test_forbidden_names_compare_whole():
    from portbench.harness import core

    assert "aukit_tpu_torch" not in core.FORBIDDEN
    names = {m.split(".")[0] for m in ("aukit_tpu_torch.stream", "jaxtyping", "aukit_tpu_x")}
    assert not names & set(core.FORBIDDEN)


def test_a_run_without_a_card_fails_and_prints_nothing():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the case is the card-less one")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "dfpwm_speakers.mixed_rates", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
