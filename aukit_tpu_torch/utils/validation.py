"""Argument validation helpers — copied from ``aukit_tpu.utils.validation``.

The reference's ``cc.expect`` checks (aukit.lua:84): every public entry point
validates argument types and ranges up front, so errors surface at the Python
boundary, never inside a device computation.
"""

from __future__ import annotations

from typing import Any

VALID_BIT_DEPTHS = (8, 16, 24, 32)
VALID_DATA_TYPES = ("signed", "unsigned", "float")


def check_bit_depth(bit_depth: int) -> int:
    if bit_depth not in VALID_BIT_DEPTHS:
        raise ValueError(f"invalid bit depth {bit_depth} (expected 8, 16, 24, or 32)")
    return bit_depth


def check_data_type(data_type: str, bit_depth: int) -> str:
    if data_type not in VALID_DATA_TYPES:
        raise ValueError(f"invalid data type {data_type!r}")
    if data_type == "float" and bit_depth != 32:
        raise ValueError("float audio must have 32-bit depth")
    return data_type


def check_range(name: str, value: Any, lo=None, hi=None):
    if lo is not None and value < lo:
        raise ValueError(f"{name} out of range: {value} < {lo}")
    if hi is not None and value > hi:
        raise ValueError(f"{name} out of range: {value} > {hi}")
    return value


def check_positive_int(name: str, value: Any) -> int:
    if not isinstance(value, int) or value < 1:
        raise ValueError(f"{name} must be a positive integer, got {value!r}")
    return value
