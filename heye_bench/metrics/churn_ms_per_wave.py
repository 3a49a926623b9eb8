"""Wall milliseconds per wave in ``SchedulerSession.churn`` (the churn
mode's ``churn`` span: the batch through the graph's delta, the compiled
snapshot's route overlay and the resident timeline's reprice, ending
synchronised; the closing batch of each iteration counts), over the
window's untraced iterations."""


def read(r: dict):
    t = r["spans"].get("churn")
    waves = r["phase_wall"].get("waves")
    return 1e3 * t / waves if t and waves else None
