"""The port's RWKV6 time-mix (``repro_torch.models.recurrent``) against the
reference package's and against its numpy-style oracle
``repro.kernels.ref.wkv_ref`` (the per-token recurrence), on carried
weights and the same seeded numpy inputs, float32 on the CPU, at 1e-5
absolute and relative: every side sums in float32 in its own order.

The chunk is ``chunk`` where it divides S, else gcd(S, chunk): S values
that the chunk does not divide (gcd 8, 4 and 1) are among the cases."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.recurrent as RR
from repro.configs import all_configs as r_configs
from repro.kernels import ref
from repro.models import ParallelCtx as RCtx
from repro_torch.models import ParallelCtx as TCtx
from repro_torch.models import recurrent as TR
from repro_torch.models.transformer import tree_map
from torch_port_util import export_params

torch.set_num_threads(1)

TOL = 1e-5
R_CTX = RCtx(compute_dtype=jnp.float32)
T_CTX = TCtx(compute_dtype=torch.float32)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _wkv_inputs(seed, B, S, H, hd):
    """r, k, v normal; log_w <= 0 as the projection makes it (-exp of a
    clipped normal); u normal; a random initial state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    log_w = -np.exp(np.clip(rng.standard_normal((B, S, H, hd)) - 1.0,
                            -8.0, 8.0)).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1
    return r, k, v, log_w, u, s0


def _carry(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)),
                    export_params(tree))


@pytest.mark.parametrize("form", ["factored", "pairwise"])
@pytest.mark.parametrize("S, chunk", [(64, 16), (40, 16), (100, 64),
                                      (37, 16), (5, 64)])
def test_wkv_chunked_matches_reference_and_oracle(S, chunk, form):
    r, k, v, log_w, u, s0 = _wkv_inputs(S, 2, S, 3, 8)
    for state0 in (None, s0):
        ro, rs = RR.wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, log_w, u)),
                                chunk=chunk, form=form,
                                state0=None if state0 is None
                                else jnp.asarray(state0))
        to, ts = TR.wkv_chunked(*(torch.tensor(a) for a in (r, k, v, log_w, u)),
                                chunk=chunk, form=form,
                                state0=None if state0 is None
                                else torch.tensor(state0))
        assert to.dtype == ts.dtype == torch.float32
        _close(to, ro)
        _close(ts, rs)
        oo, os_ = ref.wkv_ref(*(jnp.asarray(a) for a in (r, k, v, log_w, u)),
                              state0=None if state0 is None
                              else jnp.asarray(state0))
        _close(to, oo)
        _close(ts, os_)


def test_wkv_factored_clamp_in_a_long_decaying_chunk():
    """Strong decay (log w = -3 a step) over a 64-step chunk: the r-side
    exponent exp(lwprev - E) passes e^40 and is clamped.  The reference's
    factored form is then not the recurrence (a pair whose true decay is
    near 1 gets e^40 times a k-side factor far below e^-40); the port
    keeps that clamp and equals the reference's factored form there, and
    its pairwise form (decays clipped at e^-60) equals the oracle."""
    r, k, v, _, u, _ = _wkv_inputs(7, 1, 64, 2, 8)
    log_w = np.full(r.shape, -3.0, np.float32)
    rargs = [jnp.asarray(a) for a in (r, k, v, log_w, u)]
    targs = [torch.tensor(a) for a in (r, k, v, log_w, u)]
    fo, fs = TR.wkv_chunked(*targs, chunk=64, form="factored")
    ro, rs = RR.wkv_chunked(*rargs, chunk=64, form="factored")
    _close(fo, ro)
    _close(fs, rs)
    po, ps = TR.wkv_chunked(*targs, chunk=64, form="pairwise")
    oo, os_ = ref.wkv_ref(*rargs)
    _close(po, oo)
    _close(ps, os_)
    assert not np.allclose(fo.numpy(), np.asarray(oo), atol=TOL, rtol=TOL)


def _rwkv_params(seed):
    cfg = r_configs()["rwkv6-1.6b"].smoke()
    p = dict(RR.init_rwkv(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    # token-shift mixes and the decay bias made random, so that every
    # projection sees both x and x_prev
    p["mu"] = jnp.asarray(rng.uniform(0, 1, (5, cfg.d_model)), jnp.float32)
    p["w_bias"] = jnp.asarray(rng.standard_normal(cfg.d_model) - 2.0,
                              jnp.float32)
    return cfg, p


@pytest.mark.parametrize("S", [1, 24, 70])
def test_rwkv_layer_with_cache_matches_reference(S):
    """The layer (token shift, projections, the chunked scan at the
    reference's WKV_CHUNK = 64, norm, gate) and its prefill state."""
    cfg, p = _rwkv_params(1)
    x = np.random.default_rng(2).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    ro, rc = RR.rwkv_layer(p, jnp.asarray(x), cfg, R_CTX, return_cache=True)
    to, tc = TR.rwkv_layer(_carry(p), torch.tensor(x), cfg, T_CTX,
                           return_cache=True)
    _close(to, ro)
    _close(tc["state"], rc["state"])
    _close(tc["x_prev"], rc["x_prev"])


def test_rwkv_decode_steps_match_reference():
    """Twelve one-token steps from a zero cache, the cache updated in
    place, against the reference's returned copies."""
    cfg, p = _rwkv_params(3)
    tp = _carry(p)
    B = 3
    rc = RR.init_rwkv_cache(cfg, B, jnp.float32)
    tc = TR.init_rwkv_cache(cfg, B, torch.float32)
    state_buf = tc["state"]
    xs = np.random.default_rng(4).standard_normal(
        (12, B, 1, cfg.d_model)).astype(np.float32)
    for x in xs:
        ro, rc = RR.rwkv_decode(p, jnp.asarray(x), rc, cfg, R_CTX)
        to, tc = TR.rwkv_decode(tp, torch.tensor(x), tc, cfg, T_CTX)
        _close(to, ro)
    assert tc["state"] is state_buf
    _close(tc["state"], rc["state"])
    _close(tc["x_prev"], rc["x_prev"])


def test_rwkv_prefill_then_decode_continues_the_layer():
    """The port alone: a prefill of p tokens then one-token steps give the
    layer's outputs over the whole sequence."""
    cfg, p = _rwkv_params(5)
    tp = _carry(p)
    x = torch.tensor(np.random.default_rng(6).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32))
    full = TR.rwkv_layer(tp, x, cfg, T_CTX)
    _, st = TR.rwkv_layer(tp, x[:, :7], cfg, T_CTX, return_cache=True)
    cache = TR.init_rwkv_cache(cfg, 2, torch.float32)
    cache["state"].copy_(st["state"])
    cache["x_prev"].copy_(st["x_prev"])
    for t in range(7, 20):
        o, cache = TR.rwkv_decode(tp, x[:, t:t + 1], cache, cfg, T_CTX)
        _close(o, full[:, t:t + 1].numpy())


def test_init_rwkv_shapes_match_reference():
    cfg = r_configs()["rwkv6-1.6b"].smoke()
    rp = RR.init_rwkv(jax.random.key(0), cfg)
    tp = TR.init_rwkv(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in rp.items()}
    with pytest.raises(ValueError):
        TR.init_rwkv(torch.Generator(), cfg.scaled(head_dim=8))
