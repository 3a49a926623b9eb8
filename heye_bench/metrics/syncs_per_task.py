"""Device-to-host reads per task (``repro_torch.device.sync_count()``)
over the window."""


def read(r: dict):
    return r["syncs"] / r["work"] if r["work"] else None
