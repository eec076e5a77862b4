"""Published peaks of the cards the benchmark runs on (the data sheet's
dense rates at the full power limit). A roofline share is taken against
these; a card not listed gives no share."""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: 80 GB of HBM3 at 3.35 TB/s
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12},
}


def peak(device_name: str, key: str):
    for part, table in PEAKS.items():
        if part in device_name:
            return table.get(key)
    return None
