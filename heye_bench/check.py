"""Whether what the timed path produced is correct: the program's
placements, charged releases, admission verdicts and ground-truth finish
times against the plain reference's, for one iteration of the window
drawn from the run's seed.

Each number compared has its limit.  Placements, releases, verdicts and
the inputs are exact: the limit is 0.  The finish times are held by
their largest relative gap; the limit sits between what sound runs of
the program read and what the reference computed in float32 reads (the
readings it was set from are in PERF.md).
"""
from __future__ import annotations

import math

LIMITS = {"inputs_differ": 0, "verdicts_differ": 0, "placements_differ": 0,
          "releases_differ": 0, "finish_gap": 1e-11}


def _gap(a: float, b: float) -> float:
    if a == b:
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-300)


def compare(got: list, want: list) -> dict:
    """The numbers compared, from the program's rows and the reference's
    (each row: inputs, verdict or None, placement, charged release,
    finish).  Placements, releases and finishes are compared where both
    sides accepted; ``verdicts_differ`` only where the mode has
    verdicts."""
    out = {"inputs_differ": abs(len(got) - len(want))}
    if any(r[1] is not None for r in want):
        out["verdicts_differ"] = 0
    out.update(placements_differ=0, releases_differ=0)
    gap = 0.0
    for g, w in zip(got, want):
        out["inputs_differ"] += g[0] != w[0]
        if "verdicts_differ" in out:
            out["verdicts_differ"] += g[1] != w[1]
            if not g[1][0] == w[1][0] == "accepted":
                continue
        out["placements_differ"] += g[2] != w[2]
        out["releases_differ"] += g[3] != w[3]
        gap = max(gap, _gap(g[4], w[4]))
    out["finish_gap"] = gap
    return out


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in numbers)
