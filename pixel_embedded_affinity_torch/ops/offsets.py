"""Offset geometry for multi-offset affinities.

For each shift s, neighbor=4 contributes offsets [-s,0], [0,-s] (vertical
then horizontal); neighbor=8 additionally [-s,-s], [-s,s]. An offset vector
``o`` means: the channel value at pixel ``p`` is the affinity between ``p``
and ``p + o``.
"""

from __future__ import annotations


def gen_offsets(shift: int, neighbor: int = 4) -> list[list[int]]:
    """Offsets for a single shift magnitude. neighbor in {4, 8}."""
    if neighbor not in (4, 8):
        raise ValueError(f"neighbor must be 4 or 8, got {neighbor}")
    if neighbor == 4:
        return [[-shift, 0], [0, -shift]]
    return [[-shift, 0], [0, -shift], [-shift, -shift], [-shift, shift]]


def multi_offset(shifts, neighbor: int = 4) -> list[list[int]]:
    """Concatenate offsets over shift magnitudes (e.g. [1,3,5,9,27] -> 10 offsets)."""
    out: list[list[int]] = []
    for s in shifts:
        out += gen_offsets(s, neighbor=neighbor)
    return out
