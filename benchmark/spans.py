"""The program's own spans in a traced record, and the card's idle time put
down to them.

The program names stretches of its host work with ``torch.profiler``
annotations whose names start with ``pea.`` (``pea.sample``, ``pea.step``,
``pea.ema_view``, ``pea.tiled.*``); they reach the record of
:func:`.trace.capture` as ``user_annotation`` host events, on the clock of
the device activity. A program without them leaves the readers nothing to
read: each returns None.

Idle time is :func:`.trace.idle_gaps`'s (the window less the union of the
device intervals). Each instant of it goes to the innermost ``pea.`` span
the host is in then, the latest-starting one that holds it; a gap is split
where that span changes, and time outside every such span goes to None.
"""

from __future__ import annotations

from .trace import idle_gaps

PREFIX = "pea."


def spans(record: dict, name: str | None = None) -> list:
    """[[a, b, name]] µs of the program's spans (``name``'s alone if given),
    clipped to the window, in start order."""
    t0, t1 = record["window"]
    out = []
    for n, cat, ts, dur in record["host"]:
        if cat != "user_annotation" or not n.startswith(PREFIX) or name not in (None, n):
            continue
        a, b = max(ts, t0), min(ts + dur, t1)
        if b > a:
            out.append([a, b, n])
    return sorted(out)


def host_us(record: dict, name: str, less=()) -> float | None:
    """µs inside ``name``'s spans, less the part of each that spans named in
    ``less`` cover; None where there is no ``name`` span."""
    own = spans(record, name)
    if not own:
        return None
    inner = sorted(s for n in less for s in spans(record, n))
    total = 0.0
    for a, b, _ in own:
        cover, cur = 0.0, a
        for c, d, _ in inner:
            c, d = max(c, cur), min(d, b)
            if d > c:
                cover += d - c
                cur = d
        total += b - a - cover
    return total


def innermost(record: dict) -> list:
    """[[a, b, name or None]]: the window cut where the innermost program span
    changes, each piece with that span's name (None outside every span)."""
    t0, t1 = record["window"]
    own = spans(record)
    cuts = sorted({t0, t1} | {x for a, b, _ in own for x in (a, b)})
    pieces, active, i = [], [], 0
    for x, y in zip(cuts, cuts[1:]):
        while i < len(own) and own[i][0] <= x:
            active.append(own[i])
            i += 1
        active = [s for s in active if s[1] > x]
        name = max(active, key=lambda s: s[0])[2] if active else None
        if pieces and pieces[-1][2] == name and pieces[-1][1] == x:
            pieces[-1][1] = y
        else:
            pieces.append([x, y, name])
    return pieces


def idle_us(record: dict) -> dict:
    """{span name or None: µs of idle card while it was the innermost}."""
    out: dict = {}
    pieces = innermost(record)
    j = 0
    for a, b in idle_gaps(record):
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            c, d, name = pieces[k]
            lo, hi = max(a, c), min(b, d)
            if hi > lo:
                out[name] = out.get(name, 0.0) + hi - lo
            k += 1
    return out


def per_step_ms(record: dict, us: float | None) -> float | None:
    steps = record.get("steps")
    if us is None or not steps:
        return None
    return us * 1e-3 / steps


def host_ms_per_step(record: dict, name: str, less=()) -> float | None:
    return per_step_ms(record, host_us(record, name, less))


def idle_ms_per_step(record: dict, name: str) -> float | None:
    """ms a step of idle card while ``name`` was the innermost span; None
    where the record holds no ``name`` span."""
    if not spans(record, name):
        return None
    return per_step_ms(record, idle_us(record).get(name, 0.0))
