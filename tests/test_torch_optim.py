"""The port's optimizer (``repro_torch.optim``) against the reference's
(``repro.optim``) on the same seeded inputs, on the CPU.

The schedule is the reference's float32 value up to one unit in the last
place of the cosine (torch's and XLA's float32 ``cos`` differ there, and
everywhere else the values are equal); AdamW is held at 1e-6 over 5 steps on a tree that mixes dicts, tuples and dtypes (both
packages compute in float32 and differ only where XLA fuses a multiply
and an add); the global norm and the clip scale at 1e-7 relative (the
leaves are summed in the reference's order); the compressed payload and
scales are bit-equal (both round half to even) and the error buffers are
held at 1e-7."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as R
import repro_torch.optim as T
from repro_torch import tree as tr
from repro_torch.optim import compress as Tc
from repro.optim import compress as Rc

torch.set_num_threads(1)


def _np_tree(seed: int) -> dict:
    """A tree of float32 numpy leaves with dicts (unsorted keys), tuples and
    a leaf whose size is not a multiple of the compression block."""
    rng = np.random.default_rng(seed)

    def a(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"zeta": a(7, 5), "alpha": {"w": a(300), "b": a(3, scale=0.1)},
            "stack": ({"k": a(2, 4, 4)}, {"k": a(2, 4, 4, scale=3.0)}),
            "mid": a(513, scale=0.01)}


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _torch(tree, dtype=torch.float32):
    return tr.tree_map(lambda x: torch.tensor(x).to(dtype), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got_tree, want_tree, tol):
    got, want = tr.leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol)


def test_leaf_order_is_jax_order():
    tree = _np_tree(0)
    want = [np.asarray(x) for x in jax.tree.leaves(tree)]
    got = tr.leaves(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is not None and np.array_equal(g, w)
    keys = [k for k, _ in tr.flatten_with_paths(tree)]
    assert keys == ["alpha/b", "alpha/w", "mid", "stack/0/k", "stack/1/k",
                    "zeta"]


def test_schedule_matches_reference_f32():
    """Every operation but the cosine gives the reference's float32 value;
    torch's and XLA's float32 ``cos`` differ by one unit in the last place
    on a few percent of arguments, which moves the schedule by at most
    ``lr * (1 - min_lr_frac) * 0.5 * 2**-23`` plus its own rounding."""
    steps = np.arange(0, 12001, dtype=np.int32)
    for cfg_kw in ({}, {"warmup_steps": 10, "decay_steps": 100, "lr": 1.0},
                   {"warmup_steps": 0, "decay_steps": 1, "min_lr_frac": 0.0}):
        rcfg, tcfg = R.OptConfig(**cfg_kw), T.OptConfig(**cfg_kw)
        want = np.asarray(R.schedule(jnp.asarray(steps), rcfg))
        got = T.schedule(torch.tensor(steps), tcfg).numpy()
        assert got.dtype == np.float32
        cos_ulp = tcfg.lr * (1 - tcfg.min_lr_frac) * 0.5 * 2.0 ** -23
        bound = cos_ulp + 2 * np.spacing(np.abs(want))
        assert np.all(np.abs(got - want) <= bound)
        assert np.mean(got == want) > 0.95
        # warmup and the floor hold no cosine error: equal there
        flat = (steps <= tcfg.warmup_steps) | (steps >= tcfg.decay_steps)
        np.testing.assert_array_equal(got[flat], want[flat])


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_five_steps_matches_reference(state_dtype):
    rcfg = R.OptConfig(lr=1e-2, warmup_steps=2, decay_steps=10,
                       weight_decay=0.1, grad_clip=1.0,
                       state_dtype=getattr(jnp, state_dtype))
    tcfg = T.OptConfig(lr=1e-2, warmup_steps=2, decay_steps=10,
                       weight_decay=0.1, grad_clip=1.0,
                       state_dtype=getattr(torch, state_dtype))
    rp, tp = _jax(_np_tree(0)), _torch(_np_tree(0))
    rs, ts = R.init_opt_state(rp, rcfg), T.init_opt_state(tp, tcfg)
    for k in range(5):
        grads = _np_tree(10 + k)
        rp, rs, rm = R.adamw_update(rp, _jax(grads), rs, rcfg)
        tp, ts, tm = T.adamw_update(tp, _torch(grads), ts, tcfg)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]),
                                   rtol=5e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        assert int(ts["step"]) == int(rs["step"]) == k + 1
        _close(tp, rp, 1e-6)
        _close(ts["m"], rs["m"], 1e-6)
        _close(ts["v"], rs["v"], 1e-6)
    for leaf in tr.leaves(ts["m"]) + tr.leaves(ts["v"]):
        assert leaf.dtype == getattr(torch, state_dtype)


def test_adamw_updates_in_place_and_keeps_param_dtype():
    cfg = T.OptConfig(lr=1e-2, warmup_steps=1)
    params = {"w": torch.ones(4, dtype=torch.bfloat16), "b": torch.ones(2)}
    state = T.init_opt_state(params, cfg)
    w, m = params["w"], state["m"]["b"]
    new_p, new_s, _ = T.adamw_update(
        params, {"w": torch.full((4,), 0.5, dtype=torch.bfloat16),
                 "b": torch.full((2,), -0.5)}, state, cfg)
    assert new_p["w"] is w and new_s["m"]["b"] is m
    assert w.dtype == torch.bfloat16 and float(w[0]) < 1.0
    assert float(m[0]) != 0.0


def test_global_norm_and_clip_match_reference():
    tree = _np_tree(3)
    rn, tn = R.global_norm(_jax(tree)), T.global_norm(_torch(tree))
    np.testing.assert_allclose(float(tn), float(rn), rtol=1e-7)
    for max_norm in (1.0, 1e9):
        (rc, rg), (tc, tg) = (R.clip_by_global_norm(_jax(tree), max_norm),
                              T.clip_by_global_norm(_torch(tree), max_norm))
        np.testing.assert_allclose(float(tg), float(rg), rtol=1e-7)
        _close(tc, rc, 1e-7)
    # bf16 leaves keep their dtype through the clip
    clipped, _ = T.clip_by_global_norm(_torch(tree, torch.bfloat16), 1.0)
    assert all(x.dtype == torch.bfloat16 for x in tr.leaves(clipped))
    rclip, _ = R.clip_by_global_norm(_jax(tree, jnp.bfloat16), 1.0)
    _close(clipped, rclip, 1e-7)


def test_quantize_bit_equal_to_reference():
    rng = np.random.default_rng(5)
    # ties at .5 after scaling, a zero block, a ragged tail
    x = np.concatenate([rng.standard_normal(700).astype(np.float32),
                        np.zeros(256, np.float32),
                        np.array([127.0, 63.5, -0.5, 0.5, 1.5, 2.5],
                                 np.float32)])
    rq, rs = Rc.quantize(jnp.asarray(x))
    tq, ts = Tc.quantize(torch.tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        Tc.dequantize(tq, ts, x.shape, torch.float32).numpy(),
        np.asarray(Rc.dequantize(rq, rs, x.shape, jnp.float32)))


def _no_tuples(tree: dict) -> dict:
    """The tree with its tuple of layers as a dict: the reference's
    ``compress_grads`` splits its per-leaf pairs with ``is_leaf=tuple``,
    which takes a structural tuple for a pair (the port's does not)."""
    return {**tree, "stack": {str(i): x for i, x in enumerate(tree["stack"])}}


def test_compress_grads_matches_reference_over_rounds():
    rerr = R.init_error(_jax(_no_tuples(_np_tree(0))))
    terr = T.init_error(_torch(_np_tree(0)))
    for k in range(3):
        g = _np_tree(20 + k)
        rdeq, rerr = R.compress_grads(_jax(_no_tuples(g)), rerr)
        tdeq, terr = T.compress_grads(_torch(g), terr)
        assert [k for k, _ in tr.flatten_with_paths(tdeq)] == [
            k for k, _ in tr.flatten_with_paths(g)]
        for a, b in zip(tr.leaves(tdeq), jax.tree.leaves(rdeq)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _close(terr, rerr, 1e-7)
    g = _np_tree(0)
    assert T.compressed_bytes(_torch(g)) == R.compressed_bytes(_jax(g))
    # bf16 grads come back in bf16, as the reference's
    tdeq, _ = T.compress_grads(_torch(g, torch.bfloat16),
                               T.init_error(_torch(g)))
    assert all(x.dtype == torch.bfloat16 for x in tr.leaves(tdeq))
