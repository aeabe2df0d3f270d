"""Offset geometry for multi-offset affinities.

2D: for each shift s, neighbor=4 contributes offsets [-s,0], [0,-s]
(vertical then horizontal); neighbor=8 additionally [-s,-s], [-s,s].
3D: the fixed 12-channel table ``SHIFTS_3D``, channel i along axis i % 3 of
(z, y, x), in the negative direction. An offset vector ``o`` means: the
channel value at voxel ``p`` is the affinity between ``p`` and ``p + o``.
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


#: The 3D shift table: channel i shifts along axis i % 3 of (z, y, x).
SHIFTS_3D: tuple[int, ...] = (1, 1, 1, 2, 3, 3, 3, 9, 9, 4, 27, 27)


def offsets_3d(shifts=SHIFTS_3D) -> list[list[int]]:
    """The interleaved 3D shift table as explicit (dz, dy, dx) offsets:
    channel i shifts axis i % 3 by -shifts[i]."""
    out = []
    for i, s in enumerate(shifts):
        off = [0, 0, 0]
        off[i % 3] = -s
        out.append(off)
    return out
