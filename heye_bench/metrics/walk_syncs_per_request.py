"""Host reads per request inside the walk (``walk.map_batch`` spans, their
children's reads with them) over the requests decided in the traced
share's ``serve.wave`` spans, in the program spans."""


def read(r: dict):
    p = r.get("program")
    if p is None or not p["work"]["requests"]:
        return None
    reads = p["spans"].get("walk.map_batch", {}).get("reads", 0)
    return reads / p["work"]["requests"]
