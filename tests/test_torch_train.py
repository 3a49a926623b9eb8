"""The port's train step (``repro_torch.train.step``) against the
reference's (``repro.train.step``) on carried weights (the reference's
initial parameters exported to numpy and loaded by
``repro_torch.interop.params_from_numpy``) and the same synthetic batches,
in float32 on the CPU.

Tolerances: loss and aux 1e-5; ``grad_norm`` 1e-5 relative; ``lr``
exact (step 1 sits in the warmup, where the schedule has no cosine);
the moments m / v 1e-5 and the new parameters 1e-5 plus what the
moments' own difference explains (below).  Both packages compute in float32 and differ only
in the order of float32 sums.  Where a leaf is bfloat16
(``param_dtype`` / ``accum_dtype``) it is held to one bf16 unit in the
last place (2^-7 relative) beside the 1e-5: a float32 difference at a
rounding boundary flips the last bit.

Adam's step ``m_hat / (sqrt(v_hat) + eps)`` is ill conditioned where
``sqrt(v_hat)`` is near ``eps`` (1e-8): at step 1 it is ``g / (|g| +
eps)``, so a gradient of 1e-9 that the two packages' sums give 1e-10
apart (the moments agree within 1e-8 everywhere) moves the step by a
tenth of ``lr``.  So each parameter is held to 1e-5 plus the sum over the
steps so far of ``lr * |ratio_port - ratio_ref|``, the ratio computed in
float64 from each package's own moments: where the step is well
conditioned that term is far below 1e-5, and it exceeds 1e-5 on under
1 % of the parameters (held; observed gradients of 1e-11 to 1e-9 there).
A wrong update (lr, decay, eps, bias correction) is not explained by it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as Ro
import repro.train.step as Rs
import repro_torch.optim as To
import repro_torch.train.step as Ts
from repro.configs import all_configs as r_configs
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import synthetic_batches as r_batches
from repro.models import ParallelCtx as RCtx, build_model as r_build
from repro_torch import tree as tr
from repro_torch.configs import all_configs as t_configs
from repro_torch.data.pipeline import (DataConfig, make_batch_specs,
                                       synthetic_batches)
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import lru_scan as lru_kernel
from repro_torch.models import ParallelCtx as TCtx, build_model as t_build
from torch_port_util import export_params

torch.set_num_threads(1)

TOL = 1e-5
BF16_REL = 2.0 ** -7
FAMILIES = ("gemma3-1b", "recurrentgemma-9b", "granite-moe-1b-a400m",
            "rwkv6-1.6b", "whisper-large-v3", "phi-3-vision-4.2b")
R_OPT = Ro.OptConfig(lr=1e-2, warmup_steps=4, decay_steps=100)
T_OPT = To.OptConfig(lr=1e-2, warmup_steps=4, decay_steps=100)


def _pair(arch: str, remat: str = "none"):
    """(reference model, port model) of the smoke config, float32."""
    rcfg, tcfg = r_configs()[arch].smoke(), t_configs()[arch].smoke()
    rm = r_build(rcfg, RCtx(compute_dtype=jnp.float32))
    tm = t_build(tcfg, TCtx(use_kernels=False, compute_dtype=torch.float32,
                            remat=remat), device="cpu")
    return rm, tm


def _states(rm, tm, param_dtype=None):
    """The reference's initial train state and the port's on the same
    weights."""
    rs = Rs.init_train_state(rm, jax.random.key(0), R_OPT,
                             param_dtype=param_dtype and jnp.bfloat16)
    params = params_from_numpy(tm.cfg, export_params(
        jax.tree.map(lambda p: p.astype(jnp.float32), rs["params"])),
        device="cpu")
    if param_dtype is not None:
        params = tr.tree_map(lambda p: p.to(torch.bfloat16), params)
    return rs, {"params": params, "opt": To.init_opt_state(params, T_OPT)}


def _batches(cfg, n: int, batch: int = 4, seq: int = 16):
    it = synthetic_batches(DataConfig(batch=batch, seq=seq, vocab=cfg.vocab,
                                      seed=3), cfg)
    return [next(it) for _ in range(n)]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_tree(got, want, bf16: bool = False):
    g_leaves, w_leaves = tr.leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(_np(g), _np(w), atol=TOL,
                                   rtol=BF16_REL if bf16 else TOL)


def _close_metrics(tmet, rmet):
    np.testing.assert_allclose(float(tmet["loss"]), float(rmet["loss"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(tmet["aux"]), float(rmet["aux"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=TOL)


def adam_ratio(m, v, step: int, cfg) -> np.ndarray:
    """Adam's step ``m_hat / (sqrt(v_hat) + eps)`` in float64."""
    m, v = np.asarray(m, np.float64), np.asarray(v, np.float64)
    return (m / (1 - cfg.b1 ** step)) / (np.sqrt(v / (1 - cfg.b2 ** step))
                                         + cfg.eps)


def _close_params(ts, rs, lr: float, bf16: bool = False,
                  explained=None) -> list:
    """New parameters within 1e-5 plus what the two sides' own moments
    (each held to 1e-5) explain: the sum over the steps so far of ``lr *
    |ratio_port - ratio_ref|`` (see the module doc).  Returns that sum per
    leaf, to pass as ``explained`` after the next step."""
    step = int(rs["opt"]["step"])
    got = tr.leaves(ts["params"])
    want = jax.tree.leaves(rs["params"])
    moments = zip(tr.leaves(ts["opt"]["m"]), tr.leaves(ts["opt"]["v"]),
                  jax.tree.leaves(rs["opt"]["m"]),
                  jax.tree.leaves(rs["opt"]["v"]))
    explained = explained or [0.0] * len(got)
    out, n_wide, n = [], 0, 0
    for g, w, (tm, tv, rm, rv), before in zip(got, want, moments,
                                              explained):
        g, w = _np(g), _np(w)
        wide = before + lr * np.abs(adam_ratio(_np(tm), _np(tv), step, R_OPT)
                                    - adam_ratio(_np(rm), _np(rv), step, R_OPT))
        out.append(wide)
        n_wide, n = n_wide + int((wide > TOL).sum()), n + np.size(wide)
        bound = TOL + (BF16_REL if bf16 else TOL) * np.abs(w) + wide
        assert np.all(np.abs(g - w) <= bound), np.abs(g - w).max()
    assert n_wide < 0.01 * n, (n_wide, n)
    return out


def _close_state(ts, rs, lr: float, bf16: bool = False,
                 explained=None) -> list:
    out = _close_params(ts, rs, lr, bf16, explained)
    _close_tree(ts["opt"]["m"], rs["opt"]["m"], bf16)
    _close_tree(ts["opt"]["v"], rs["opt"]["v"], bf16)
    assert int(ts["opt"]["step"]) == int(rs["opt"]["step"])
    return out


def _clone(state):
    return tr.tree_map(lambda t: t.clone(), state)


def _r_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def test_cross_entropy_masking_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, :3] = Ts.IGNORE
    got = Ts.cross_entropy(torch.tensor(logits), labels)
    want = Rs.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # uniform logits -> log(10) on the unmasked positions; all masked -> 0
    zeros = torch.zeros((1, 4, 10))
    assert float(Ts.cross_entropy(zeros, np.array([[1, 2, -1, -1]]))) == \
        pytest.approx(np.log(10.0), rel=1e-6)
    assert float(Ts.cross_entropy(zeros, np.full((1, 4), -1))) == 0.0


def test_synthetic_batches_bit_equal_to_reference():
    for arch in ("gemma3-1b", "phi-3-vision-4.2b", "whisper-large-v3"):
        cfg = t_configs()[arch].smoke()
        rit = r_batches(RDataConfig(batch=3, seq=20, vocab=cfg.vocab, seed=7),
                        r_configs()[arch].smoke())
        tit = synthetic_batches(DataConfig(batch=3, seq=20, vocab=cfg.vocab,
                                           seed=7), cfg)
        specs = make_batch_specs(DataConfig(batch=3, seq=20, vocab=cfg.vocab),
                                 cfg)
        for _ in range(3):
            rb, tb = next(rit), next(tit)
            assert sorted(rb) == sorted(tb) == sorted(specs)
            for k in rb:
                assert tb[k].dtype == rb[k].dtype
                np.testing.assert_array_equal(tb[k], rb[k])
                assert tuple(tb[k].shape) == specs[k].shape
                assert torch.from_numpy(tb[k]).dtype == specs[k].dtype
        if cfg.frontend == "vision":
            assert (tb["labels"][:, :cfg.n_patches] == Ts.IGNORE).all()


# ---------------------------------------------------------------------------
# train step against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_one_train_step_matches_reference(arch):
    rm, tm = _pair(arch)
    rs, ts = _states(rm, tm)
    (b,) = _batches(tm.cfg, 1)
    rs, rmet = jax.jit(Rs.make_train_step(rm, R_OPT))(rs, _r_batch(b))
    ts, tmet = Ts.make_train_step(tm, T_OPT)(ts, b)
    _close_metrics(tmet, rmet)
    assert float(tmet["lr"]) == float(rmet["lr"])
    _close_state(ts, rs, float(rmet["lr"]))
    if tm.cfg.n_experts:
        assert float(tmet["aux"]) > 0.0      # the MoE aux loss is live


def test_three_steps_gemma3_match_reference():
    rm, tm = _pair("gemma3-1b")
    rs, ts = _states(rm, tm)
    rstep = jax.jit(Rs.make_train_step(rm, R_OPT))
    tstep = Ts.make_train_step(tm, T_OPT)
    explained = None
    for b in _batches(tm.cfg, 3):
        rs, rmet = rstep(rs, _r_batch(b))
        ts, tmet = tstep(ts, b)
        _close_metrics(tmet, rmet)
        assert float(tmet["lr"]) == float(rmet["lr"])
        explained = _close_state(ts, rs, float(rmet["lr"]),
                                 explained=explained)


def test_tied_embedding_gradient_sums_gather_and_unembed():
    """gemma3-1b ties its embeddings: the table's gradient is the sum of
    the gather's and the unembed's, as the reference's."""
    rm, tm = _pair("gemma3-1b")
    assert tm.cfg.tie_embeddings
    rs, ts = _states(rm, tm)
    (b,) = _batches(tm.cfg, 1)
    rgrads = jax.grad(lambda p: Rs.make_loss_fn(rm)(p, _r_batch(b))[0])(
        rs["params"])
    _, tgrads = Ts._grads(Ts.make_loss_fn(tm), ts["params"], b)
    np.testing.assert_allclose(_np(tgrads["embed"]), _np(rgrads["embed"]),
                               atol=TOL, rtol=TOL)
    assert "lm_head" not in tgrads


def test_microbatches_match_reference_and_full_batch():
    rm, tm = _pair("gemma3-1b")
    rs, ts = _states(rm, tm)
    (b,) = _batches(tm.cfg, 1)
    ts_full = _clone(ts)
    rs, rmet = jax.jit(Rs.make_train_step(rm, R_OPT, microbatches=2))(
        rs, _r_batch(b))
    ts, tmet = Ts.make_train_step(tm, T_OPT, microbatches=2)(ts, b)
    _close_metrics(tmet, rmet)
    assert float(tmet["aux"]) == 0.0          # as the reference's scan path
    _close_state(ts, rs, float(rmet["lr"]))
    # and against the port's own full batch: the same update, up to the
    # order of the float32 sums
    ts_full, fmet = Ts.make_train_step(tm, T_OPT)(ts_full, b)
    np.testing.assert_allclose(float(tmet["loss"]), float(fmet["loss"]),
                               rtol=TOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(fmet["grad_norm"]), rtol=TOL)
    for a, c in zip(tr.leaves(ts["params"]), tr.leaves(ts_full["params"])):
        np.testing.assert_allclose(_np(a), _np(c), atol=TOL, rtol=TOL)


def test_bf16_accumulation_and_bf16_params_match_reference():
    rm, tm = _pair("gemma3-1b")
    (b,) = _batches(tm.cfg, 1)
    # accum_dtype=bf16 over two microbatches
    rs, ts = _states(rm, tm)
    rs, rmet = jax.jit(Rs.make_train_step(
        rm, R_OPT, microbatches=2, accum_dtype=jnp.bfloat16))(rs, _r_batch(b))
    ts, tmet = Ts.make_train_step(tm, T_OPT, microbatches=2,
                                  accum_dtype=torch.bfloat16)(ts, b)
    np.testing.assert_allclose(float(tmet["loss"]), float(rmet["loss"]),
                               rtol=TOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=BF16_REL)
    _close_state(ts, rs, float(rmet["lr"]), bf16=True)
    # param_dtype=bf16: master weights in bf16
    rs, ts = _states(rm, tm, param_dtype="bf16")
    assert all(p.dtype == torch.bfloat16 for p in tr.leaves(ts["params"]))
    rs, rmet = jax.jit(Rs.make_train_step(rm, R_OPT))(rs, _r_batch(b))
    ts, tmet = Ts.make_train_step(tm, T_OPT)(ts, b)
    np.testing.assert_allclose(float(tmet["loss"]), float(rmet["loss"]),
                               rtol=TOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=BF16_REL)
    _close_state(ts, rs, float(rmet["lr"]), bf16=True)
    assert all(p.dtype == torch.bfloat16 for p in tr.leaves(ts["params"]))


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-1b-a400m"])
def test_remat_block_equals_none(arch):
    _, tm = _pair(arch)
    _, tr_model = _pair(arch, remat="block")
    rm, _ = _pair(arch)
    _, ts = _states(rm, tm)
    ts_remat = _clone(ts)
    (b,) = _batches(tm.cfg, 1, seq=24)
    ts, met = Ts.make_train_step(tm, T_OPT)(ts, b)
    ts_remat, met_r = Ts.make_train_step(tr_model, T_OPT)(ts_remat, b)
    assert float(met_r["loss"]) == float(met["loss"])
    assert float(met_r["aux"]) == float(met["aux"])
    np.testing.assert_allclose(float(met_r["grad_norm"]),
                               float(met["grad_norm"]), rtol=1e-6)
    for a, c in zip(tr.leaves(ts_remat), tr.leaves(ts)):
        np.testing.assert_allclose(_np(a), _np(c), atol=1e-6, rtol=1e-6)


def test_eval_step_matches_reference():
    rm, tm = _pair("whisper-large-v3")
    rs, ts = _states(rm, tm)
    (b,) = _batches(tm.cfg, 1)
    rmet = Rs.make_eval_step(rm)(rs["params"], _r_batch(b))
    tmet = Ts.make_eval_step(tm)(ts["params"], b)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(tmet[k]), float(rmet[k]), atol=TOL,
                                   rtol=TOL)
    assert tmet["loss"].grad_fn is None


# ---------------------------------------------------------------------------
# the kernels are forward only: training through them is refused
# ---------------------------------------------------------------------------
def test_train_step_refuses_the_kernel_route():
    model = t_build(t_configs()["gemma3-1b"].smoke(),
                    TCtx(compute_dtype=torch.float32), device="cpu")
    assert model.ctx.use_kernels
    with pytest.raises(ValueError, match="use_kernels=False"):
        Ts.make_train_step(model, T_OPT)


@pytest.mark.parametrize("arch", ["gemma3-1b", "recurrentgemma-9b"])
def test_kernel_wrappers_refuse_grad_recording(arch):
    """Autograd through B5 / B6 raises on the CPU too (the card would give
    no gradient); under no_grad, or with inputs that need none, the
    wrappers run."""
    model = t_build(t_configs()[arch].smoke(),
                    TCtx(compute_dtype=torch.float32), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    (b,) = _batches(model.cfg, 1)
    leaves = [p.detach().requires_grad_(True) for p in tr.leaves(params)]
    with pytest.raises(RuntimeError, match=r"use_kernels=False"):
        Ts.make_loss_fn(model)(tr.unflatten(params, leaves), b)
    with torch.no_grad():
        Ts.make_loss_fn(model)(tr.unflatten(params, leaves), b)
    Ts.make_loss_fn(model)(params, b)
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention"):
        fa_kernel.flash_attention(q, q.detach(), q.detach())
    a = torch.rand(1, 8, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="lru_scan"):
        lru_kernel.lru_scan(a, a.detach())
    with torch.no_grad():
        lru_kernel.lru_scan(a, a)
