"""The example servers of ``aukit_tpu_torch.examples`` against the JAX
scripts in examples/ (loaded by path, as they are), on the CPU at small
sizes: batch_server 8 lanes x 0.5 s, flac_radio_fleet 4 stations x 2 s,
mixed_fleet_server 3 stations x 1 s with one rotation. For the same
arguments each port example (``device="cpu"``) prints the JAX script's
lines, with the wall time and the realtime factor masked; ``main()``'s dict
holds what it printed, and ``on_window`` sees each tick's window. The port's FLAC station writer gives the bytes of the
JAX example's ``_make_station`` for the same RNG. Without a card the
examples refuse the default device.

Cost: the plain DFPWM loops (~80-100 us a step here) set batch_server's,
the JAX station writer (a Python loop a residual) the writer's.
"""

import contextlib
import importlib.util
import io
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aukit_tpu_torch.examples import batch_server, flac_radio_fleet, mixed_fleet_server

ROOT = Path(__file__).resolve().parent.parent
PORT = {"batch_server": batch_server, "flac_radio_fleet": flac_radio_fleet,
        "mixed_fleet_server": mixed_fleet_server}
ARGS = {"batch_server": (8, 0.5), "flac_radio_fleet": (4, 2), "mixed_fleet_server": (3, 1, 1)}
TIMES = re.compile(r"wall [0-9.]+s|in [0-9.]+s|[0-9]+x realtime")


def jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(main, *args, **kwargs):
    """(what ``main`` printed with its times masked, what it returned)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(*args, **kwargs)
    return TIMES.sub("T", out.getvalue()), result


@pytest.mark.parametrize("name", sorted(PORT))
def test_example_prints_the_jax_scripts_lines(name):
    want, _ = printed(jax_example(name).main, *ARGS[name])
    seen = []
    got, summary = printed(PORT[name].main, *ARGS[name], device="cpu",
                           on_window=lambda *r: seen.append(r))
    assert got == want
    # on_window saw each tick that gave a window, with its mask
    assert [int(np.asarray(mask).sum()) for _, mask, _ in seen] == summary["live"]
    # the dict holds the printed numbers
    if name == "batch_server":
        assert f"ticks={summary['ticks']} " in got
        assert f"underrun_ticks={summary['underrun_ticks']}\n" in got
        assert summary["sink_samples"] == summary["samples_decoded"]
    else:
        ticks = [line for line in got.splitlines() if line.startswith("tick ")]
        assert [int(t.split(": ")[1].split("/")[0]) for t in ticks] == summary["live"]
        assert len(ticks) == summary["ticks"]
        assert f"\n{summary['samples_decoded']} samples" in got
        assert f"; {summary['poisoned']} poisoned" in got
    if name == "mixed_fleet_server":
        assert summary["rotations"] == 3 and summary["rotated"][-1] == 3


@pytest.mark.parametrize("seed,seconds", [(0, 2), (7, 11)])
def test_station_writer_matches_jax_bytes(seed, seconds):
    """Byte for byte, FLAC frame numbers from one UTF-8 byte (2 s) to two
    (11 s: 129 frames)."""
    want = jax_example("flac_radio_fleet")._make_station(np.random.default_rng(seed), seconds)
    got = flac_radio_fleet._make_station(np.random.default_rng(seed), seconds)
    assert got == want


def test_flac_example_runs_as_a_module_on_the_cpu():
    """``python -m aukit_tpu_torch.examples.flac_radio_fleet 2 1 --device
    cpu``: the JAX script's lines, and no JAX module loaded."""
    code = ("import runpy, sys; sys.argv = ['x', '2', '1', '--device', 'cpu'];"
            "runpy.run_module('aukit_tpu_torch.examples.flac_radio_fleet', run_name='__main__');"
            "print('JAX', any(m == 'jax' or m.startswith(('jax.', 'aukit_tpu.')) or m == 'aukit_tpu'"
            " for m in sys.modules))")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr
    want, _ = printed(jax_example("flac_radio_fleet").main, 2, 1)
    assert TIMES.sub("T", run.stdout) == want + "JAX False\n"


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
@pytest.mark.parametrize("name", sorted(PORT))
def test_example_without_a_card_refuses_the_default_device(name, capsys):
    """Without ``--device cpu`` each example asks for the card and raises
    before it synthesises anything: it does not carry on on the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT[name].cli([])
    assert capsys.readouterr().out == ""
