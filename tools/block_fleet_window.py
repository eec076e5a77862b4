"""The block fleet of ``chip_smoke.py`` alone, on the card: its main path
(32768 lanes, host-fed, its kernels against their plain versions) and then
two profiled windows (``[step_breakdown]`` lines), in about a minute.

    python3 tools/block_fleet_window.py

It takes the ``chip_smoke.py`` of the current directory, so two checkouts
(say an earlier commit's ``git archive`` in a directory that git ignores, and
this one) can be run in turns on one card in one call, each from its own
root, to tell a change in the window's time from the host's drift.
"""
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> None:
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    specs, groups = chip_smoke.block_fleet_data()
    chip_smoke.phase_block_fleet(specs, groups)
    torch.cuda.empty_cache()
    for _ in range(2):
        chip_smoke.phase_block_step_breakdown(specs, groups)


if __name__ == "__main__":
    main()
