"""Bandwidth churn in plain Python: a batch of new link bandwidths set on
the fleet at an instant.

The walk prices transfers from the fleet's links, so its cached transfer
times go with the old bandwidths.  The ground truth settles every
transfer in flight over a changed link at the instant of the batch and
moves it on at the new fair share from there (paper section 5.4.1,
dynamic network conditions).
"""
from __future__ import annotations

from .des import Truth


class ChurnTruth(Truth):
    """The ground truth with bandwidth batches applied between advances."""

    def churn(self, batch: list, at: float) -> None:
        """Set each (link index, bandwidth) of ``batch``, in order, at
        ``at`` (never before the clock); the last write to a link holds."""
        self.now = max(self.now, at)
        for k, bw in batch:
            self.fl.links[k][0] = bw
            self.dirty_links.add(k)
        self.m._comm.clear()
        self._flush()
