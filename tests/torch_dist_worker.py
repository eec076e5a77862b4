"""One process of a two-process ``torch.distributed`` group (gloo) running the
port's multi-process layer: ``multihost_pipeline_step`` over this process's
lanes of a seeded batch, then ``MultiHostEngine`` over its lanes of a seeded
DFPWM fleet, stepped in lockstep until ``global_done()``. Imports torch,
numpy and aukit_tpu_torch only.

    python tests/torch_dist_worker.py PID PORT DEVICE LANES NBYTES CHUNK SHARDS OUT

PID 0 or 1; PORT a free localhost port; DEVICE "cpu" or "cuda"; LANES the
lanes of each process; NBYTES each engine lane's bytes at 48 kHz, stepped in
CHUNK-byte chunks; SHARDS the shards of each process's mesh. Every process
draws the whole batch and fleet from ``default_rng(7)`` (pipeline bytes
uint8[2 * LANES, 96], then engine bytes uint8[2 * LANES, NBYTES]) and keeps
its own rows. It prints ``DIST_PIPE PID SHA256`` (of its pipeline rows) and
``DIST_OK PID``, one ``DIST_STEP PID i SHA256`` line a step (the SHA-256 of
the step's rows, ready mask and positions, in that order, as bytes),
``DIST_LAUNCHES PID {json}`` (each kernel wrapper's launches in this
process) and ``DIST_ENGINE_OK PID STEPS``; with OUT other than "-" it saves
its pipeline rows (``pipe``) and each step's rows, masks and positions
(``rows{i}``, ``ready{i}``, ``pos{i}``) to the .npz file OUT.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from aukit_tpu_torch import kernels  # noqa: E402
from aukit_tpu_torch.parallel import distributed as dist  # noqa: E402
from aukit_tpu_torch.stream.batch import LaneSpec  # noqa: E402

PIPE_BYTES = 96


def main(argv):
    pid, port, device = int(argv[0]), argv[1], argv[2]
    lanes, nbytes, chunk, shards = map(int, argv[3:7])
    out_path = argv[7]
    dist.init_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
    try:
        mesh = dist.global_mesh(device=device, local_devices=shards)
        assert (mesh.process_index, mesh.process_count, mesh.size) == (pid, 2, shards), mesh
        rng = np.random.default_rng(7)
        lo = pid * lanes
        pipe_bytes = rng.integers(0, 256, (2 * lanes, PIPE_BYTES), dtype=np.uint8)
        step, to_global = dist.multihost_pipeline_step(mesh, lanes, PIPE_BYTES)
        g_bytes, g_state = to_global(pipe_bytes[lo: lo + lanes])
        out, *_state = step(g_bytes, *g_state)
        saved = {"pipe": torch.cat([o.cpu() for o in out]).numpy()}
        print(f"DIST_PIPE {pid} {hashlib.sha256(saved['pipe'].tobytes()).hexdigest()}",
              flush=True)
        print(f"DIST_OK {pid}", flush=True)

        feed = rng.integers(0, 256, (2 * lanes, nbytes), dtype=np.uint8)
        eng = dist.MultiHostEngine(LaneSpec("dfpwm", 48000, chunk_bytes=chunk), lanes, mesh)
        for i in range(lanes):
            eng.feed(i, feed[lo + i].tobytes())
            eng.feed(i, None)
        steps = 0
        while not eng.global_done():
            chunk_out, ready, pos = eng.step()
            rows = eng.local_rows(chunk_out)
            digest = hashlib.sha256(rows.tobytes() + ready.tobytes() + pos.tobytes())
            print(f"DIST_STEP {pid} {steps} {digest.hexdigest()}", flush=True)
            if out_path != "-":
                saved.update({f"rows{steps}": rows, f"ready{steps}": ready, f"pos{steps}": pos})
            steps += 1
        if out_path != "-":
            np.savez(out_path, **saved)
        launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
        print(f"DIST_LAUNCHES {pid} {json.dumps(launches)}", flush=True)
        print(f"DIST_ENGINE_OK {pid} {steps}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
