"""Times kernel (g), the FLAC LPC restore (``aukit_tpu_torch/csrc/flac.cu``),
on the card at chip_smoke.py's shapes: 32768 rows x 4096 samples at order 8,
and the 7168 rows of one step of the 2048-lane FLAC fleet. CUDA events, the
best of three runs of 10 launches. Where the tree's wrapper takes
``wrapped`` it is timed a second time reporting the wrapped rows.

The tree timed is the one at ``--root`` (default: this script's repository),
so two trees compare in one run on one card, e.g. a parent commit unpacked
into ``_checkout/parent``:

    python3 tools/time_lpc_restore.py --root _checkout/parent --label parent
    python3 tools/time_lpc_restore.py --label change

Prints the card's name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="tree")
    opts = ap.parse_args()
    sys.path.insert(0, str(Path(opts.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs
    from aukit_tpu_torch.kernels import flac_cuda as kg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    takes_wrapped = "wrapped" in inspect.signature(kg.lpc_restore_kernel).parameters
    rng = np.random.default_rng(16)
    for shape, rows in (("profile", cs.LPC_ROWS), ("fleet_step", cs.LPC_FLEET_ROWS)):
        args = cs.lpc_bench_args(rng, rows, cs.FLAC_N)
        runs = [("rows", {})]
        if takes_wrapped:
            flags = torch.empty(rows, dtype=torch.int32, device="cuda")
            runs.append(("rows_and_wrapped", {"wrapped": flags}))
        for variant, kw in runs:
            kg.lpc_restore_kernel(*args, **kw)
            ms = min(cs.event_ms(lambda: kg.lpc_restore_kernel(*args, **kw), 10)
                     for _ in range(3))
            line = {"tree": opts.label, "shape": shape, "variant": variant, "rows": rows,
                    "samples": cs.FLAC_N, "ms": ms,
                    "gsamples_per_s": rows * cs.FLAC_N / ms / 1e6}
            if kw:
                line["rows_reported_wrapped"] = int(kw["wrapped"].sum())
            print(json.dumps(line), flush=True)
        del args
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
