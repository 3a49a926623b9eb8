"""Synthetic token pipeline: deterministic, seedable, host-side generation
with background prefetch onto the device — the reference package's
``data/pipeline.py`` on PyTorch.

:func:`synthetic_batches` is a copy of the reference's numpy generator:
for one seed and config the batches are bit-equal (tokens, labels, the
masked patch labels and the ``patches`` / ``frames`` inputs).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike


@dataclass(frozen=True)
class DataConfig:
    batch: int
    seq: int
    vocab: int
    seed: int = 0


def synthetic_batches(cfg: DataConfig, model_cfg=None) -> Iterator[dict]:
    """Markov-ish synthetic tokens (not uniform noise, so loss can fall);
    numpy arrays on the host."""
    rng = np.random.default_rng(cfg.seed)
    # low-entropy transition structure: each token prefers a few successors
    fanout = 8
    nxt = rng.integers(0, cfg.vocab, size=(min(cfg.vocab, 4096), fanout))
    while True:
        toks = np.empty((cfg.batch, cfg.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=cfg.batch)
        pick = rng.integers(0, fanout, size=(cfg.batch, cfg.seq))
        jump = rng.random((cfg.batch, cfg.seq)) < 0.05
        randv = rng.integers(0, cfg.vocab, size=(cfg.batch, cfg.seq))
        for t in range(cfg.seq):
            follow = nxt[toks[:, t] % nxt.shape[0], pick[:, t]]
            toks[:, t + 1] = np.where(jump[:, t], randv[:, t], follow)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if model_cfg is not None and model_cfg.frontend == "vision":
            batch["labels"][:, :model_cfg.n_patches] = -1     # mask patch slots
            batch["patches"] = rng.standard_normal(
                (cfg.batch, model_cfg.n_patches, model_cfg.d_model)).astype(np.float32) * 0.02
        if model_cfg is not None and model_cfg.frontend == "audio":
            batch["frames"] = rng.standard_normal(
                (cfg.batch, model_cfg.src_seq, model_cfg.d_model)).astype(np.float32) * 0.02
        yield batch


class BatchSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def make_batch_specs(cfg: DataConfig, model_cfg=None) -> dict:
    """Shape and dtype of every entry of a batch."""
    specs = {"tokens": BatchSpec((cfg.batch, cfg.seq), torch.int32),
             "labels": BatchSpec((cfg.batch, cfg.seq), torch.int32)}
    if model_cfg is not None and model_cfg.frontend == "vision":
        specs["patches"] = BatchSpec(
            (cfg.batch, model_cfg.n_patches, model_cfg.d_model), torch.float32)
    if model_cfg is not None and model_cfg.frontend == "audio":
        specs["frames"] = BatchSpec(
            (cfg.batch, model_cfg.src_seq, model_cfg.d_model), torch.float32)
    return specs


class Prefetcher:
    """Background-thread prefetch of host batches (depth-bounded queue).

    With ``device`` the worker thread copies each batch there before
    queueing it, where the reference ``device_put``s.  The copy is a
    synchronous ``.to(device)`` (it returns once the data is on the
    device), so a batch taken from the queue is ready on any stream."""

    def __init__(self, it: Iterator[dict], depth: int = 2,
                 device: DeviceLike = None) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._device = None if device is None else torch.device(device)
        self._stop = False

        def worker():
            for item in it:
                if self._stop:
                    return
                if self._device is not None:
                    item = {k: torch.as_tensor(v).to(self._device)
                            for k, v in item.items()}
                self._q.put(item)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self) -> None:
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
