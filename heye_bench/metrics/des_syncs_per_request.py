"""Host reads per request inside the ground truth (its outermost ``des.*``
spans, their children's reads with them) over the requests decided in
the traced share's ``serve.wave`` spans, in the program spans."""


def read(r: dict):
    p = r.get("program")
    if p is None or not p["work"]["requests"]:
        return None
    reads = p["layers"].get("des", {}).get("reads", 0)
    return reads / p["work"]["requests"]
