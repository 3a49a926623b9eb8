"""Wall milliseconds per request in the serving loop's mapping phase
(``ServeStats.phase_wall["map"]``: the walk of each admission wave), over
the window's untraced loops."""


def read(r: dict):
    t = r["phase_wall"].get("map")
    return 1e3 * t / r["work"] if t and r["work"] else None
