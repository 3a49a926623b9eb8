"""A source that sends at a fixed period from a phase of its own: each
sensor reads every ``period`` seconds, starting at a phase drawn uniform
over one period.  Over a horizon of whole periods every source sends the
same number of times, whatever the seed: the seed moves the instants,
not the work."""
from __future__ import annotations

import numpy as np


def times(period: float, span: float, rng: np.random.Generator):
    """The instants in ``[0, span)``, in order."""
    phase = rng.uniform(0.0, period)
    n = int(np.ceil((span - phase) / period))
    t = phase + period * np.arange(max(n, 0))
    return t[t < span]
