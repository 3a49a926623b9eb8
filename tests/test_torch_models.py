"""The port's model substrate against the reference package's, on carried
weights (reference parameters exported to numpy and loaded by
``repro_torch.interop.params_from_numpy``) and the same seeded tokens, in
float32 on the CPU.

Modules are held at 1e-5 and whole models (logits after every layer) at
1e-4, absolute and relative: both packages compute in float32, and the
only differences are the order of float32 sums in matmuls, softmaxes and
scans (observed <= 1.1e-6 on logits of magnitude ~2).  The port runs both
of its routes: ``use_kernels=True`` (the kernels' wrappers, which on CPU
tensors run the kernels' plain versions) and ``use_kernels=False`` (the
reference's plain route ported as module code); the reference runs its
own plain route, and once its Pallas route in interpret mode."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as RL
import repro.models.recurrent as RR
from repro.configs import all_configs as r_configs
from repro.models import ParallelCtx as RCtx, build_model as r_build
from repro_torch.configs import all_configs as t_configs
from repro_torch.interop import params_from_numpy
from repro_torch.models import ParallelCtx as TCtx, build_model as t_build
from repro_torch.models import layers as TL
from repro_torch.models import recurrent as TR
from repro_torch.models.transformer import tree_map
from torch_port_util import export_params

torch.set_num_threads(1)

MODULE_TOL = 1e-5
MODEL_TOL = 1e-4
R_CTX = RCtx(compute_dtype=jnp.float32, flash_threshold=1 << 30)
ALL_ARCHS = tuple(sorted(r_configs()))


def t_ctx(use_kernels: bool) -> TCtx:
    return TCtx(compute_dtype=torch.float32, use_kernels=use_kernels)


def carry(tree):
    """A reference (sub)tree of parameters as float32 CPU tensors."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)),
                    export_params(tree))


def close(got, want, tol=MODULE_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def randn(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def both(x):
    return jnp.asarray(x), torch.tensor(x)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
def test_rms_norm():
    rx, tx = both(randn(0, 2, 5, 48, scale=3.0))
    rg, tg = both(randn(1, 48, scale=0.3))
    close(TL.rms_norm(tx, tg, 1e-6), RL.rms_norm(rx, rg, 1e-6))


def test_rope():
    rx, tx = both(randn(2, 2, 9, 3, 16))
    pos = np.arange(9) + 5
    close(TL.rope(tx, torch.tensor(pos), 10_000.0),
          RL.rope(rx, jnp.asarray(pos), 10_000.0))


def test_embed_unembed_with_softcap():
    cfg = r_configs()["gemma2-2b"].smoke()
    table = randn(3, cfg.vocab, cfg.d_model, scale=0.05)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 7))
    rt, tt = both(table)
    close(TL.embed(torch.tensor(toks), tt, torch.float32),
          RL.embed(jnp.asarray(toks), rt, jnp.float32))
    rx, tx = both(randn(5, 2, 7, cfg.d_model))
    close(TL.unembed(tx, tt, 30.0), RL.unembed(rx, rt, 30.0))


@pytest.mark.parametrize("arch", ["gemma2-2b", "minitron-4b"])
def test_mlp(arch):
    cfg = r_configs()[arch].smoke()
    p = RL.init_mlp(jax.random.key(1), cfg)
    rx, tx = both(randn(6, 2, 11, cfg.d_model))
    close(TL.mlp(carry(p), tx, cfg, t_ctx(True)), RL.mlp(p, rx, cfg, R_CTX))


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("kind", ["global", "local"])
def test_attention_layer(kind, use_kernels):
    """gemma2 smoke: GQA, attention softcap, window 16 < S = 40."""
    cfg = r_configs()["gemma2-2b"].smoke()
    p = RL.init_attention(jax.random.key(2), cfg)
    rx, tx = both(randn(7, 2, 40, cfg.d_model))
    pos = np.arange(40)
    want = RL.attention_layer(p, rx, cfg, R_CTX, kind, jnp.asarray(pos))
    got = TL.attention_layer(carry(p), tx, cfg, t_ctx(use_kernels), kind,
                             torch.tensor(pos))
    close(got, want)


@pytest.mark.parametrize("kind", ["global", "local"])
def test_attention_decode_rolling_buffer(kind):
    """Twenty one-token steps against a cache: the local layer's buffer
    (window 8) wraps twice."""
    cfg = r_configs()["gemma3-1b"].smoke().scaled(window=8)
    p = RL.init_attention(jax.random.key(3), cfg)
    tp = carry(p)
    B, S = 2, 20
    rc = RL.init_attn_cache(cfg, B, S, kind, jnp.float32)
    tc = TL.init_attn_cache(cfg, B, S, kind, torch.float32)
    xs = randn(8, S, B, 1, cfg.d_model)
    for t in range(S):
        pos = np.full((B,), t)
        ro, rc = RL.attention_decode(p, jnp.asarray(xs[t]), rc, cfg, R_CTX,
                                     kind, jnp.asarray(pos))
        to, tc = TL.attention_decode(tp, torch.tensor(xs[t]), tc, cfg,
                                     t_ctx(True), kind, torch.tensor(pos))
        close(to, ro)
    close(tc["k"], rc["k"])
    close(tc["v"], rc["v"])


def _rglru_params(seed):
    """RG-LRU parameters with the zero-initialised gates made random, so
    that the gates depend on the input."""
    cfg = r_configs()["recurrentgemma-9b"].smoke()
    p = dict(RR.init_rglru(jax.random.key(seed), cfg))
    w = cfg.lru_width
    for i, name in enumerate(("alpha_r", "beta_r", "alpha_i", "beta_i",
                              "conv_b")):
        p[name] = jnp.asarray(randn(seed * 10 + i, w, scale=0.5))
    return cfg, p


@pytest.mark.parametrize("S", [2, 37])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_rglru_layer_with_cache(use_kernels, S):
    cfg, p = _rglru_params(4)
    rx, tx = both(randn(9, 2, S, cfg.d_model))
    ro, rcache = RR.rglru_layer(p, rx, cfg, R_CTX, return_cache=True)
    to, tcache = TR.rglru_layer(carry(p), tx, cfg, t_ctx(use_kernels),
                                return_cache=True)
    close(to, ro)
    close(tcache["h"], rcache["h"])
    close(tcache["conv"], rcache["conv"])


def test_rglru_decode_steps():
    cfg, p = _rglru_params(5)
    tp = carry(p)
    B = 3
    rc = RR.init_rglru_cache(cfg, B, jnp.float32)
    tc = TR.init_rglru_cache(cfg, B, torch.float32)
    xs = randn(10, 12, B, 1, cfg.d_model)
    for x in xs:
        ro, rc = RR.rglru_decode(p, jnp.asarray(x), rc, cfg, R_CTX)
        to, tc = TR.rglru_decode(tp, torch.tensor(x), tc, cfg, t_ctx(True))
        close(to, ro)
    close(tc["h"], rc["h"])
    close(tc["conv"], rc["conv"])


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
B, S, P = 2, 24, 8       # batch, sequence, prefill length (then S-P decodes)


def frontend_inputs(cfg, seed: int = 14) -> dict:
    """The modality stubs' numpy inputs of a smoke config, from the shapes
    ``configs/shapes.py`` gives them: ``patches`` (vision), ``frames``
    (audio), seeded."""
    out = {}
    if cfg.frontend == "vision":
        out["patches"] = randn(seed, B, cfg.n_patches, cfg.d_model, scale=0.5)
    if cfg.is_encdec:
        out["frames"] = randn(seed + 1, B, cfg.src_seq, cfg.d_model)
    return out


def r_batch(toks, extra: dict) -> dict:
    return {"tokens": jnp.asarray(toks),
            **{k: jnp.asarray(v) for k, v in extra.items()}}


def t_batch(toks, extra: dict) -> dict:
    return {"tokens": torch.tensor(toks),
            **{k: torch.tensor(v) for k, v in extra.items()}}


@functools.lru_cache(maxsize=None)
def reference_run(arch: str):
    """The reference's plain route: params, tokens, frontend inputs,
    forward logits and aux, prefill logits and the teacher-forced decode
    logits at positions P..S-1."""
    cfg = r_configs()[arch].smoke()
    model = r_build(cfg, R_CTX)
    params = model.init(jax.random.key(0))
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (B, S))
    extra = frontend_inputs(cfg)
    fwd, aux = model.forward(params, r_batch(toks, extra))
    cache = model.init_cache(B, S, dtype=jnp.float32)
    pre, cache = model.prefill(params, r_batch(toks[:, :P], extra), cache)
    decode = jax.jit(model.decode_step)
    steps = []
    for t in range(P, S):
        lt, cache = decode(params, cache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.full((B,), t, jnp.int32))
        steps.append(np.asarray(lt))
    return (export_params(params), toks, extra, np.asarray(fwd),
            float(aux), np.asarray(pre), np.stack(steps, 1))


def port_model(arch: str, use_kernels: bool, tree=None, **overrides):
    cfg = t_configs()[arch].smoke().scaled(**overrides)
    model = t_build(cfg, t_ctx(use_kernels), device="cpu")
    params = (params_from_numpy(cfg, tree, device="cpu") if tree is not None
              else model.init(torch.Generator().manual_seed(0)))
    return model, params


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_matches_reference(arch, use_kernels):
    """forward (logits and MoE aux loss), prefill and 16 teacher-forced
    decode steps (the local layers' rolling buffer of 16 wraps; MoE
    routing of two tokens a step; whisper's cross-attention over the
    prefilled encoder keys) on carried weights."""
    tree, toks, extra, fwd, aux_want, pre, steps = reference_run(arch)
    model, params = port_model(arch, use_kernels, tree)
    got, aux = model.forward(params, t_batch(toks, extra))
    assert got.dtype == torch.float32
    close(got, fwd, MODEL_TOL)
    if model.cfg.n_experts > 0:
        close(aux, aux_want, MODEL_TOL)
    else:
        assert float(aux) == aux_want == 0.0
    cache = model.init_cache(B, S, dtype=torch.float32)
    lp, cache = model.prefill(params, t_batch(toks[:, :P], extra), cache)
    close(lp, pre, MODEL_TOL)
    for i, t in enumerate(range(P, S)):
        lt, cache = model.decode_step(params, cache,
                                      torch.tensor(toks[:, t:t + 1]),
                                      torch.full((B,), t))
        close(lt, steps[:, i], MODEL_TOL)


def _kernel_route_against_pallas(arch: str) -> None:
    tree, toks, extra, _, _, _, _ = reference_run(arch)
    cfg = r_configs()[arch].smoke()
    rmodel = r_build(cfg, RCtx(compute_dtype=jnp.float32, use_kernels=True))
    want, _ = rmodel.forward(jax.tree.map(jnp.asarray, tree),
                             r_batch(toks, extra))
    model, params = port_model(arch, True, tree)
    got, _ = model.forward(params, t_batch(toks, extra))
    close(got, want, MODEL_TOL)


def test_model_kernel_routes_agree_with_reference_pallas():
    """recurrentgemma (flash attention + LRU scan): the port's kernel route
    against the reference's Pallas route in interpret mode."""
    _kernel_route_against_pallas("recurrentgemma-9b")


def test_encdec_kernel_route_agrees_with_reference_pallas():
    """whisper (flash attention unmasked in the encoder, causal in the
    decoder): the port's kernel route against the reference's Pallas
    route in interpret mode."""
    _kernel_route_against_pallas("whisper-large-v3")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The port on its own: prefill(tokens[:p]) then teacher-forced decode
    reproduces the forward logits, for every cache type.  MoE capacity is
    raised (as in the reference's own test): a grouped prefill and a
    per-token decode legitimately drop different token-slots."""
    cfg = t_configs()[arch].smoke()
    model, params = port_model(
        arch, True, **({"capacity_factor": 16.0} if cfg.n_experts else {}))
    toks = np.random.default_rng(12).integers(0, model.cfg.vocab, (B, S))
    extra = frontend_inputs(cfg, seed=15)
    full, _ = model.forward(params, t_batch(toks, extra))
    cache = model.init_cache(B, S, dtype=torch.float32)
    lp, cache = model.prefill(params, t_batch(toks[:, :P], extra), cache)
    close(lp, full[:, P - 1], MODEL_TOL)
    toks = torch.tensor(toks)
    for t in range(P, S):
        lt, cache = model.decode_step(params, cache, toks[:, t:t + 1],
                                      torch.full((B,), t))
        close(lt, full[:, t], MODEL_TOL)


@pytest.mark.parametrize("p", [4, 20])
def test_local_window_rolling_cache(p):
    """Decode beyond the window (p=4) and prefill longer than the window
    (p=20 > window=8: the buffer holds the last 8 tokens, rolled)."""
    cfg = t_configs()["gemma3-1b"].smoke().scaled(window=8)
    model = t_build(cfg, t_ctx(True), device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    n = 32
    toks = torch.tensor(np.random.default_rng(13).integers(0, cfg.vocab,
                                                           (1, n)))
    full, _ = model.forward(params, {"tokens": toks})
    cache = model.init_cache(1, n, dtype=torch.float32)
    _, cache = model.prefill(params, {"tokens": toks[:, :p]}, cache)
    for t in range(p, n):
        lt, cache = model.decode_step(params, cache, toks[:, t:t + 1],
                                      torch.full((1,), t))
        close(lt, full[:, t], MODEL_TOL)


# ---------------------------------------------------------------------------
# configs and the parameter layout
# ---------------------------------------------------------------------------
def test_configs_match_reference():
    import dataclasses
    assert sorted(t_configs()) == sorted(r_configs())
    for arch, cfg in t_configs().items():
        ref = r_configs()[arch]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), arch
        assert dataclasses.asdict(cfg.smoke()) == dataclasses.asdict(ref.smoke())
        assert cfg.param_count() == ref.param_count()


def _layout_and_count(arch: str) -> None:
    tree = reference_run(arch)[0]
    _, params = port_model(arch, True)
    shapes = []
    tree_map(lambda a, b: shapes.append((tuple(a.shape), np.shape(b))),
             params, tree)
    assert shapes and all(a == b for a, b in shapes)
    n = sum(int(np.prod(a)) for a, _ in shapes)
    assert abs(n - t_configs()[arch].smoke().param_count()) / n < 0.05


def test_params_layout_and_count():
    """The port's own init has the reference's tree and leaf shapes."""
    _layout_and_count("recurrentgemma-9b")


@pytest.mark.parametrize("arch", sorted(set(ALL_ARCHS) - {"recurrentgemma-9b"}))
def test_params_layout_of_every_config(arch):
    """The same for the other nine configs: MoE, RWKV6, the encoder and
    cross-attention trees included."""
    _layout_and_count(arch)


def test_params_from_numpy_refuses_a_wrong_layout():
    arch = "recurrentgemma-9b"
    cfg = t_configs()[arch].smoke()
    tree = reference_run(arch)[0]
    bad = dict(tree, stack={"blocks": tree["stack"]["blocks"][:2],
                            "rem": ()})
    with pytest.raises(ValueError):
        params_from_numpy(cfg, bad, device="cpu")
    unstacked = tree_map(lambda a: a[0], tree["stack"]["blocks"])
    with pytest.raises(ValueError):
        params_from_numpy(cfg, dict(tree, stack={"blocks": unstacked,
                                                 "rem": ()}), device="cpu")


def test_init_draws_from_the_generator():
    model = t_build(t_configs()["gemma3-1b"].smoke(), device="cpu")
    a = model.init(torch.Generator().manual_seed(3))
    b = model.init(torch.Generator().manual_seed(3))
    c = model.init(torch.Generator().manual_seed(4))
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
