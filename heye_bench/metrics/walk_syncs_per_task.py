"""Host reads per task inside the walk (``walk.map_batch`` spans, their
children's reads with them) over the tasks that entered ``map_batch``
(the ``walk.tasks`` counter), in the traced iteration's program spans."""


def read(r: dict):
    p = r.get("program")
    if p is None or not p["counters"].get("walk.tasks"):
        return None
    reads = p["spans"].get("walk.map_batch", {}).get("reads", 0)
    return reads / p["counters"]["walk.tasks"]
