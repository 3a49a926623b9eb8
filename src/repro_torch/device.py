"""Device and dtype policy of the port — the one place that decides both.

Rule: everything numeric runs on ``cuda`` unless the caller asks for the
CPU with an explicit ``device="cpu"``.  The request is carried by the
``HWGraph`` and inherited by everything built from it (snapshot,
slowdown model, traverser, ledger, orchestrators, session).  With no
CUDA device and no explicit ``"cpu"`` the entry points **raise**;
nothing falls back to the CPU on its own.

Numeric state is ``float64`` / ``int64`` / ``bool`` (the DES and
slowdown contracts are a hard 1e-9, and the H100 has native fp64).

Device -> host reads are funnelled through :func:`host_list` /
:func:`host_item` / :func:`host_numpy` / :func:`nonzero` so a run can
report how many synchronising copies its control plane needed
(``sync_count``).  The port avoids the operations that synchronise
implicitly (boolean-mask indexing, ``unique``, ``bincount``,
``repeat_interleave`` without ``output_size``) on its main path.
"""
from __future__ import annotations

import threading
from typing import Union

import numpy as np
import torch

from . import spans
from .spans import OPEN as _SPANS

FLOAT = torch.float64
INT = torch.int64
BOOL = torch.bool

DeviceLike = Union[None, str, torch.device]

_syncs = 0
# reads may come from several host threads at once (the group-sharded walk)
_sync_lock = threading.Lock()


def _count_sync() -> None:
    """Count one host read, and in the innermost open span of the calling
    thread when a span recorder is open."""
    global _syncs
    with _sync_lock:
        _syncs += 1
        if _SPANS:
            spans.count_read()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA device (raises when there is none);
    ``"cpu"`` or any explicit device -> that device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device: none is available and "
                "no explicit device=\"cpu\" was given")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def f64(data, device: torch.device) -> torch.Tensor:
    """Host data (list / numpy / scalar sequence) -> float64 tensor."""
    return torch.as_tensor(np.asarray(data, dtype=np.float64), device=device)


def i64(data, device: torch.device) -> torch.Tensor:
    """Host data -> int64 tensor."""
    return torch.as_tensor(np.asarray(data, dtype=np.int64), device=device)


def host_list(t: torch.Tensor) -> list:
    """Tensor -> Python list (one synchronising copy when on the card)."""
    if t.is_cuda:
        _count_sync()
    return t.tolist()


def host_item(t: torch.Tensor):
    """0-d / 1-element tensor -> Python scalar."""
    if t.is_cuda:
        _count_sync()
    return t.item()


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy array on the host."""
    if t.is_cuda:
        _count_sync()
        return t.cpu().numpy()
    return t.numpy()


def nonzero(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the set entries of a 1-D mask.  On the card the result's
    length has to reach the host before the result can be allocated, so
    this counts as one synchronising read."""
    if mask.is_cuda:
        _count_sync()
    return torch.nonzero(mask)[:, 0]


def bytes_key(*tensors: torch.Tensor) -> bytes:
    """Content key over several small tensors with ONE host copy: the
    values are widened to float64 (ints and bools this size are exact)
    and concatenated; callers put the lengths into the key themselves."""
    flat = [t.reshape(-1).to(FLOAT) for t in tensors]
    return host_numpy(torch.cat(flat)).tobytes()


def sync_count() -> int:
    """Synchronising device -> host reads since the last reset."""
    return _syncs


def reset_sync_count() -> None:
    global _syncs
    _syncs = 0
