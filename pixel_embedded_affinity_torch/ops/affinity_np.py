"""Host-side label utilities (numpy)."""

from __future__ import annotations

import numpy as np


def relabel(seg: np.ndarray, do_type: bool = False) -> np.ndarray:
    """Relabel instances to consecutive ids 1..N (0 stays background)."""
    uid = np.unique(seg)
    if len(uid) == 1 and uid[0] == 0:
        return seg
    uid = uid[uid > 0]
    mid = int(uid.max()) + 1
    m_type = seg.dtype
    if do_type:
        if mid < 2 ** 8:
            m_type = np.uint8
        elif mid < 2 ** 16:
            m_type = np.uint16
        elif mid < 2 ** 32:
            m_type = np.uint32
        else:
            m_type = np.uint64
    mapping = np.zeros(mid, dtype=m_type)
    mapping[uid] = np.arange(1, len(uid) + 1, dtype=m_type)
    return mapping[seg]
