"""The launch counters of the port's kernel wrappers, in one registry.

Each wrapper that launches a hand-written kernel is declared with
:func:`counted` in the module that defines it. It then carries
``.launches``, which it raises by one where it issues its kernel to a
stream, and nowhere else. Inside a CUDA graph capture that call records the
kernel into the graph, once; the graph's replays run it again without a
call, so the counters do not see them. A module's wrappers join
:data:`COUNTED` when it is imported, so a wrapper that has launched is
always in it.
"""

from __future__ import annotations

# wrapper name -> wrapper
COUNTED: dict = {}


def counted(*fns):
    """Register each of ``fns`` and set its count to 0."""
    for fn in fns:
        if COUNTED.setdefault(fn.__name__, fn) is not fn:
            raise ValueError(f"two counted wrappers named {fn.__name__}")
        fn.launches = 0


def launch_counts() -> dict:
    """Each registered wrapper's count, by name."""
    return {name: fn.launches for name, fn in COUNTED.items()}


def reset_launch_counts():
    for fn in COUNTED.values():
        fn.launches = 0
