"""The scheduler kernels' share of their roofline: the summed least
time of every launch in the traced iteration (``roofline.py``) over the
summed device time of those kernels in the trace.  Nothing when no such
kernel ran."""


def read(r: dict):
    least, device = r["roofline"]
    return 100.0 * least / device if device > 0 else None
