"""Scheduler kernel launches per task: the sum of the port's launch
counters over the window."""


def read(r: dict):
    return r["launches"] / r["work"] if r["work"] else None
