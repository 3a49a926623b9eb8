"""Wall milliseconds per task inside ``SchedulerSession.map_pending``
(the harness's timer, the span ending synchronised), over the window's
untraced iterations."""


def read(r: dict):
    t = r["spans"].get("map_pending")
    return 1e3 * t / r["work"] if t and r["work"] else None
