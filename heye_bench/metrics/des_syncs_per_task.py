"""Host reads per task inside the ground truth (its outermost ``des.*``
spans, their children's reads with them) over the tasks that entered
``map_batch`` (the ``walk.tasks`` counter), in the traced iteration's
program spans."""


def read(r: dict):
    p = r.get("program")
    if p is None or not p["counters"].get("walk.tasks"):
        return None
    reads = p["layers"].get("des", {}).get("reads", 0)
    return reads / p["counters"]["walk.tasks"]
