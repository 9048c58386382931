"""Shared helpers of the spec engines: Z-drop and C's shift.

The parts of ``ksw2_tpu/spec/common.py`` that the port's copies of the
row-DP engines and the scalar ``gg2`` use.
"""
from __future__ import annotations

import numpy as np

from ..core.result import ExtzResult


def sra1(x: int) -> int:
    """C ``x >> 1`` on int (arithmetic shift = floor division by 2)."""
    return x >> 1  # Python's >> is arithmetic/floor, same as gcc on x86


def apply_zdrop(ez: ExtzResult, is_rot: bool, H: int, a: int, b: int, zdrop: int, e: int) -> bool:
    """Z-drop test, updating the running extension max.

    Mirror of ``ksw_apply_zdrop`` (reference: ksw2.h:191-207): the drop is
    gap-compensated by ``|Δt-Δq|*e`` off the best diagonal.  Returns True when
    extension should stop.
    """
    if is_rot:
        r, t = a, b
    else:
        r, t = a + b, a
    if H > ez.max:
        ez.max = H
        ez.max_t = t
        ez.max_q = r - t
    elif t >= ez.max_t and r - t >= ez.max_q:
        tl = t - ez.max_t
        ql = (r - t) - ez.max_q
        l = tl - ql if tl > ql else ql - tl
        if zdrop >= 0 and ez.max - H > zdrop + l * e:
            ez.zdropped = True
            return True
    return False


__all__ = ["sra1", "apply_zdrop"]
