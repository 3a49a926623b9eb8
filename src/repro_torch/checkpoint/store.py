"""Checkpointing of trees of tensors — the reference package's
``checkpoint/store.py`` on PyTorch, with the same files:

    <dir>/step_<N>/manifest.json     structure, shapes, dtypes
    <dir>/step_<N>/arrays.npz        flat leaf arrays (key = leaf path)
    <dir>/step_<N>/DONE              commit marker (atomic completion)

Leaf keys join a leaf's dict keys and tuple indexes with ``/`` in the
order ``jax.tree_util`` flattens (:mod:`repro_torch.tree`); dtypes numpy
cannot store (bfloat16, float8) are saved as a same-width ``uint`` view
with the true dtype in the manifest.  So a checkpoint written by either
package restores in the other, bit for bit.  The manifest's
``"treedef"`` is this package's structure string; restoring reads only
``"leaves"``.

* async save (a background thread; ``wait()`` joins): the tree is copied
  to the host first, so training goes on while the files are written;
* restore reads only checkpoints with a DONE marker, so an interrupted
  save is invisible; each leaf lands on the device and dtype of the
  matching leaf of ``like``.

A DTensor leaf (training on a mesh) is saved whole (``full_tensor()``),
so the files do not depend on the mesh; restoring into a DTensor leaf
gives it back its mesh and placements, each rank keeping its block.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from .. import tree as tr

Tree = Any

# dtypes numpy's savez cannot serialize -> (torch dtype, signed view used to
# cross into numpy, stored unsigned view)
_VIEW_AS = {"bfloat16": (torch.bfloat16, torch.int16, np.uint16),
            "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.uint8),
            "float8_e5m2": (torch.float8_e5m2, torch.int8, np.uint8)}
_TORCH_NAME = {v[0]: k for k, v in _VIEW_AS.items()}


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A leaf as a host numpy array in its stored form (bf16 / f8 as uint)."""
    if isinstance(x, DTensor):
        x = x.full_tensor()      # the whole leaf, in the reference's format
    # a copy even on the CPU: the state is updated in place after the save
    t = x.detach().to("cpu", copy=True)
    name = _TORCH_NAME.get(t.dtype)
    if name is None:
        return t.numpy()
    return t.view(_VIEW_AS[name][1]).numpy().view(_VIEW_AS[name][2])


def _dtype_name(x: torch.Tensor) -> str:
    return _TORCH_NAME.get(x.dtype) or str(x.dtype).removeprefix("torch.")


def _host_tree(tree: Tree) -> tuple[dict, dict]:
    """({key: stored host array}, {key: true dtype name})."""
    flat = tr.flatten_with_paths(tree)
    return ({k: _to_host(v) for k, v in flat},
            {k: _dtype_name(v) for k, v in flat})


def _write(arrays: dict, dtypes: dict, structure: str, directory: str,
           step: int) -> str:
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "treedef": structure,
                "leaves": {k: {"shape": list(a.shape), "dtype": dtypes[k]}
                           for k, a in arrays.items()}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "DONE"), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def save(tree: Tree, directory: str, step: int) -> str:
    """Synchronous save. Returns the checkpoint path."""
    arrays, dtypes = _host_tree(tree)
    return _write(arrays, dtypes, tr.structure(tree), directory, step)


class AsyncSaver:
    """Fire-and-forget checkpointing with at most one save in flight."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, tree: Tree, directory: str, step: int) -> None:
        self.wait()
        arrays, dtypes = _host_tree(tree)       # on the caller's thread
        structure = tr.structure(tree)

        def work():
            self.last_path = _write(arrays, dtypes, structure, directory,
                                    step)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "DONE")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _from_host(arr: np.ndarray, true_dt: str) -> torch.Tensor:
    if true_dt in _VIEW_AS:                 # un-view bf16 / f8 payloads
        dt, signed, _ = _VIEW_AS[true_dt]
        return torch.from_numpy(arr.view(np.dtype(
            str(signed).removeprefix("torch.")))).view(dt)
    return torch.from_numpy(np.asarray(arr, order="C"))


def restore(directory: str, like: Tree, step: Optional[int] = None) -> Tree:
    """Restore into the structure of ``like``: leaves matched by key, each
    on the device and in the dtype of its ``like`` leaf (and on its mesh,
    with its placements, where it is a DTensor)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "DONE")):
        raise IOError(f"checkpoint {path} is not committed")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in tr.flatten_with_paths(like):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            true_dt = manifest["leaves"].get(key, {}).get("dtype",
                                                          str(arr.dtype))
            t = _from_host(arr, true_dt).to(device=leaf.device,
                                            dtype=leaf.dtype)
            if isinstance(leaf, DTensor):
                t = distribute_tensor(t, leaf.device_mesh, leaf.placements,
                                      src_data_rank=None)
            out.append(t)
    return tr.unflatten(like, out)
