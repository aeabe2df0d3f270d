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


def shift_channels_offsets(shift_channels: int = 3) -> list[list[int]]:
    """Named mutex-watershed offset sets (3/7/9/15/17/23 channels).

    Parity with scripts_ac3ac4/utils/shift_channels.py:2-48; used when
    training directly against mutex-style GT (cfg shift_channels != None).
    """
    base = [[-1, 0, 0], [0, -1, 0], [0, 0, -1]]
    diag = [[-1, -1, -1], [-1, 1, 1], [-1, -1, 1], [-1, 1, -1]]
    dam = [[0, -9, 0], [0, 0, -9]]
    lr = [[0, -9, -9], [0, 9, -9], [0, -9, -4], [0, -4, -9], [0, 4, -9],
          [0, 9, -4]]
    diag27 = [[0, -27, 0], [0, 0, -27]]
    extra = [[0, -27, -27], [0, 27, -27], [0, -27, -9], [0, -9, -27],
             [0, 9, -27], [0, 27, -9]]
    table = {
        3: base,
        7: base + diag,
        9: base + diag + dam,
        15: base + diag + dam + lr,
        17: base + diag + dam + lr + diag27,
        23: base + diag + dam + lr + diag27 + extra,
    }
    if shift_channels not in table:
        raise NotImplementedError(shift_channels)
    return [list(o) for o in table[shift_channels]]
