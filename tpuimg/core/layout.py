"""Launch-math helpers (reference ``iDivUp``/``iAlignUp``,
`Integral/cuda_utils.h:224-254`)."""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    """Ceiling division (reference ``iDivUp``, `Integral/cuda_utils.h:224`)."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round x up to a multiple of m (reference ``iAlignUp``)."""
    return cdiv(x, m) * m
