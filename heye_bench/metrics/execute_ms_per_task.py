"""Wall milliseconds per task inside ``SchedulerSession.execute`` (the
ground truth's timeline engine; the span ends synchronised), over the
window's untraced iterations."""


def read(r: dict):
    t = r["spans"].get("execute")
    return 1e3 * t / r["work"] if t and r["work"] else None
