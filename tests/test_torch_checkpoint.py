"""The port's checkpoint store (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): the same files, so a checkpoint
written by either package restores in the other bit for bit (bfloat16
leaves included); and the reference's own checkpoint tests, mirrored."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as R
import repro_torch.checkpoint as T
from repro_torch import tree as tr

torch.set_num_threads(1)


def _np_tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((8, 4)).astype(np.float32),
                       "layers": ({"a": np.ones(3, np.float32)},
                                  {"a": np.zeros(3, np.float32)})},
            "opt": {"step": np.array(7, np.int32),
                    "m": rng.standard_normal((8, 4)).astype(np.float32)}}


def _torch_tree(seed: int = 0) -> dict:
    t = tr.tree_map(torch.tensor, _np_tree(seed))
    t["opt"]["m"] = t["opt"]["m"].to(torch.bfloat16)
    return t


def _jax_tree(seed: int = 0) -> dict:
    t = jax.tree.map(jnp.asarray, _np_tree(seed))
    t["opt"]["m"] = t["opt"]["m"].astype(jnp.bfloat16)
    return t


def _bits(x) -> np.ndarray:
    """A leaf's raw bits (bf16 as uint16), for bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _same(a_tree, b_tree):
    a_leaves = tr.leaves(a_tree)
    b_leaves = jax.tree.leaves(b_tree)
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_files_and_keys_match_the_reference(tmp_path):
    tpath = T.save(_torch_tree(), str(tmp_path / "t"), step=3)
    rpath = R.save(_jax_tree(), str(tmp_path / "r"), step=3)
    assert os.path.basename(tpath) == os.path.basename(rpath) == "step_00000003"
    assert sorted(os.listdir(tpath)) == sorted(os.listdir(rpath)) == [
        "DONE", "arrays.npz", "manifest.json"]
    tman = json.load(open(os.path.join(tpath, "manifest.json")))
    rman = json.load(open(os.path.join(rpath, "manifest.json")))
    assert tman["leaves"] == rman["leaves"]
    assert tman["leaves"]["opt/m"]["dtype"] == "bfloat16"
    assert tman["treedef"] == "{'opt': {'m': *, 'step': *}, 'params': " \
        "{'layers': ({'a': *}, {'a': *}), 'w': *}}"
    with np.load(os.path.join(tpath, "arrays.npz")) as t, \
            np.load(os.path.join(rpath, "arrays.npz")) as r:
        assert sorted(t.files) == sorted(r.files)
        for k in r.files:
            assert t[k].dtype == r[k].dtype
            np.testing.assert_array_equal(t[k], r[k])


def test_port_save_reference_restore(tmp_path):
    tree = _torch_tree(1)
    T.save(tree, str(tmp_path), step=5)
    like = jax.tree.map(jnp.zeros_like, _jax_tree(0))
    out = R.restore(str(tmp_path), like)
    _same(tree, out)


def test_reference_save_port_restore(tmp_path):
    tree = _jax_tree(2)
    R.save(tree, str(tmp_path), step=5)
    like = tr.tree_map(torch.zeros_like, _torch_tree(0))
    out = T.restore(str(tmp_path), like)
    _same(out, tree)
    assert out["opt"]["m"].dtype == torch.bfloat16
    assert isinstance(out["params"]["layers"], tuple)


def test_roundtrip(tmp_path):
    tree = _torch_tree()
    path = T.save(tree, str(tmp_path), step=3)
    assert os.path.exists(os.path.join(path, "DONE"))
    out = T.restore(str(tmp_path), tr.tree_map(torch.zeros_like, tree))
    for a, b in zip(tr.leaves(tree), tr.leaves(out)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_latest_step_and_uncommitted_invisible(tmp_path):
    tree = _torch_tree()
    T.save(tree, str(tmp_path), step=1)
    T.save(tree, str(tmp_path), step=5)
    assert T.latest_step(str(tmp_path)) == 5
    # fake an interrupted save: a directory without DONE
    os.makedirs(os.path.join(str(tmp_path), "step_00000009"))
    assert T.latest_step(str(tmp_path)) == 5
    assert T.restore(str(tmp_path), tree) is not None      # restores 5
    with pytest.raises(IOError):
        T.restore(str(tmp_path), tree, step=9)


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        T.restore(str(tmp_path), _torch_tree())


def test_restore_missing_leaf_raises(tmp_path):
    tree = _torch_tree()
    T.save(tree, str(tmp_path), step=0)
    bigger = dict(tree)
    bigger["extra"] = torch.zeros(())
    with pytest.raises(KeyError):
        T.restore(str(tmp_path), bigger)


def test_async_save_snapshots_before_in_place_updates(tmp_path):
    tree = _torch_tree()
    saver = T.AsyncSaver()
    saver.save(tree, str(tmp_path), step=2)
    want = tree["params"]["w"].clone()
    tree["params"]["w"].add_(1.0)          # the state moves on meanwhile
    saver.wait()
    assert T.latest_step(str(tmp_path)) == 2
    out = T.restore(str(tmp_path), tree)
    assert torch.equal(out["params"]["w"], want)
    # a second save joins the first
    saver.save(tree, str(tmp_path), step=4)
    saver.wait()
    assert T.latest_step(str(tmp_path)) == 4
    assert saver.last_path.endswith("step_00000004")


def test_overwrite_same_step(tmp_path):
    tree = _torch_tree()
    T.save(tree, str(tmp_path), step=1)
    tree2 = tr.tree_map(lambda x: x if x.dtype == torch.int32 else x + 1, tree)
    T.save(tree2, str(tmp_path), step=1)
    out = T.restore(str(tmp_path), tree, step=1)
    assert torch.equal(out["params"]["w"], tree2["params"]["w"])


def test_restore_casts_to_the_like_leaf(tmp_path):
    tree = _torch_tree()
    T.save(tree, str(tmp_path), step=0)
    like = tr.tree_map(lambda x: x.double() if x.is_floating_point() else x,
                       tree)
    out = T.restore(str(tmp_path), like)
    assert out["params"]["w"].dtype == torch.float64
    assert torch.equal(out["params"]["w"], tree["params"]["w"].double())
