"""The port's multi-process layer (``aukit_tpu_torch.parallel.distributed``)
in a real two-process ``torch.distributed`` group on the CPU (gloo), two
shards a process, against the JAX package: the twin of
tests/test_distributed.py. Each worker (tests/torch_dist_worker.py, torch
only) runs ``multihost_pipeline_step`` on its 8 lanes of a seeded 16-lane
batch and ``MultiHostEngine`` on its 8 lanes of a seeded fleet (1500 bytes a
lane in 750-byte chunks: the decoder state carries across steps), and saves
its rows; the test holds them bit-equal to the JAX package's unsharded
``decode_pipeline_scan(normalize_peak=0.9)`` (jitted) over the whole batch
and to the JAX ``BatchStreamEngine(use_pallas=False)`` over the union of
the feeds."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aukit_tpu.codecs.dfpwm import DfpwmState
from aukit_tpu.parallel.pipeline import decode_pipeline_scan
from aukit_tpu.stream.batch import BatchStreamEngine, LaneSpec

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_worker.py")
LANES, NBYTES, CHUNK, SHARDS = 8, 1500, 750, 2
TIMEOUT = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_multihost_layer(tmp_path):
    port = str(_free_port())
    outs = [tmp_path / f"rank{i}.npz" for i in range(2)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(i), port, "cpu", str(LANES),
                               str(NBYTES), str(CHUNK), str(SHARDS), str(outs[i])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0].decode("utf-8", "replace"))
    except subprocess.TimeoutExpired:
        pytest.fail(f"distributed workers timed out after {TIMEOUT} s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {i} failed:\n{log}"
        assert f"DIST_OK {i}" in log and f"DIST_ENGINE_OK {i} 2" in log, log

    # the workers' draws, in their order
    rng = np.random.default_rng(7)
    pipe_bytes = rng.integers(0, 256, (2 * LANES, 96), dtype=np.uint8)
    feed = rng.integers(0, 256, (2 * LANES, NBYTES), dtype=np.uint8)
    scan = jax.jit(decode_pipeline_scan, static_argnums=(2, 3))
    ref_pipe = np.asarray(scan(jnp.asarray(pipe_bytes), DfpwmState.zeros(2 * LANES), 48000,
                               0.9)[0])
    ref = BatchStreamEngine([LaneSpec("dfpwm", 48000, chunk_bytes=CHUNK)] * (2 * LANES),
                            use_pallas=False)
    for i in range(2 * LANES):
        ref.feed(i, feed[i].tobytes())
        ref.feed(i, None)
    ref_steps = [(np.asarray(c), m.copy(), p.copy()) for c, m, p in iter(ref.step, None)]
    assert len(ref_steps) == 2
    for pid, path in enumerate(outs):
        got = np.load(path)
        lo = pid * LANES
        np.testing.assert_array_equal(got["pipe"], ref_pipe[lo: lo + LANES])
        for k, (chunk, mask, pos) in enumerate(ref_steps):
            np.testing.assert_array_equal(got[f"rows{k}"], chunk[lo: lo + LANES])
            np.testing.assert_array_equal(got[f"ready{k}"], mask[lo: lo + LANES])
            np.testing.assert_array_equal(got[f"pos{k}"], pos[lo: lo + LANES])


def test_multihost_engine_arguments():
    """Outside a process group: one process, its lanes over its shards; the
    JAX engine's ValueError when the lanes do not divide the shards, and a
    TypeError for a foreign mesh."""
    from aukit_tpu_torch.parallel import distributed as dist
    from aukit_tpu_torch.stream.batch import LaneSpec as TLaneSpec

    mesh = dist.global_mesh(device="cpu", local_devices=2)
    assert (mesh.process_index, mesh.process_count, mesh.size) == (0, 1, 2)
    with pytest.raises(ValueError, match="must divide"):
        dist.MultiHostEngine(TLaneSpec("dfpwm", 48000), 3, mesh)
    with pytest.raises(TypeError, match="make_mesh"):
        dist.MultiHostEngine(TLaneSpec("dfpwm", 48000), 2, object())
    eng = dist.MultiHostEngine(TLaneSpec("dfpwm", 48000, chunk_bytes=16), 2, mesh)
    eng.feed(0, bytes(range(40)))
    eng.feed_many([None, None])
    steps = 0
    while not eng.global_done():
        out, ready, pos = eng.step()
        assert out.shape == (2, 128) and ready.tolist() == [True, False]
        assert not eng.local_rows(out)[1].any()
        steps += 1
    assert steps == 3 and eng.local_done
