"""The bound arithmetic: spreads of a cell's end-to-end metrics over sets of
runs, and the bound they give.

    python3 benchmark/spread.py RESULTS.jsonl [...]

Each line of a results file is ``{"workload", "set", "seed", "result"}`` with
``result`` a run's result object. A spread is the distance between the first
and third quartiles (``statistics.quantiles(values, n=4)``) as a share of the
median. For each cell and metric it prints each set's median and spread, the
wider of the sets' spreads, the spread of all runs together, the mean of the
sets' spreads with each set's run farthest from its median left out, and five
times the widest spread, floored at 1%: the bound the runs support.
"""

from __future__ import annotations

import json
import statistics
import sys


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values) -> list:
    """The values without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def summarize(rows) -> dict:
    """{workload: {metric: {...}}} from result rows."""
    cells: dict = {}
    for r in rows:
        res = r["result"]
        for name, m in res["metrics"].items():
            cells.setdefault(r["workload"], {}).setdefault(name, {}).setdefault(
                r["set"], []).append(m["value"])
    out: dict = {}
    for workload, metrics in cells.items():
        for name, sets in metrics.items():
            per = {s: {"n": len(v), "median": statistics.median(v),
                       "spread": spread(v) if len(v) >= 2 else None}
                   for s, v in sorted(sets.items())}
            spreads = [p["spread"] for p in per.values() if p["spread"] is not None]
            every = [x for v in sets.values() for x in v]
            tight = [spread(trimmed(v)) for v in sets.values() if len(v) >= 3]
            widest = max(spreads) if spreads else None
            out.setdefault(workload, {})[name] = {
                "sets": per, "widest": widest,
                "all_runs": spread(every) if len(every) >= 2 else None,
                "trimmed_mean": sum(tight) / len(tight) if tight else None,
                "bound": None if widest is None else min(0.25, max(0.01, 5 * widest))}
    return out


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    rows = []
    for path in paths:
        with open(path) as f:
            rows += [json.loads(line) for line in f if line.strip()]
    print(json.dumps(summarize(rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
