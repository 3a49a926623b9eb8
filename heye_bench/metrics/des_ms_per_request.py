"""Wall milliseconds per request in the resident timeline's advance and
the ledger's reconciliation (``ServeStats.phase_wall["advance"] +
["sync"]``), over the window's untraced loops."""


def read(r: dict):
    pw = r["phase_wall"]
    if "advance" not in pw or not r["work"]:
        return None
    return 1e3 * (pw["advance"] + pw["sync"]) / r["work"]
