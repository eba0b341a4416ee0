"""Slice-count math for rational SR factors: the port's own copy of
``rehrseg_tpu.utils.patch`` (:16-45).

These decide how many slices a volume is padded by so that a rational SR
factor lands on the ideal output slice count (``projected_size ==
ideal_size``). Patch sampling (the rest of that module) is still to be
ported with SR training.
"""

from __future__ import annotations

from math import floor


def projected_size(n_slices: int, p: int, scale: float) -> int:
    """Slices produced by pad-by-``p`` -> fractional resize -> integer
    shuffle -> crop."""
    scale_tilde = scale / floor(scale)
    return round((n_slices + p) * scale_tilde) * floor(scale) \
        - round(p * scale)


def calc_slices_to_crop(p: int, scale: float) -> int:
    return round(p * scale)


def ideal_size(n_slices: int, scale: float) -> int:
    """Target slice count after SR."""
    return round(n_slices * scale)


def find_integer_p(n_slices: int, s: float, max_iter: int = 1000) -> int:
    """Smallest pad ``p`` with ``projected_size(n, p, s) == ideal_size(n,
    s)``; 0 when none is found within ``max_iter``."""
    p = 0
    for _ in range(max_iter):
        if projected_size(n_slices, p, s) == ideal_size(n_slices, s):
            return p
        p += 1
    if projected_size(n_slices, p, s) == ideal_size(n_slices, s):
        return p
    return 0
