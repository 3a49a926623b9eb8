"""The port's MoE layer (``repro_torch.models.moe``) against the reference
package's, on carried weights and the same seeded numpy inputs, in float32
on the CPU.

Routing is compared exactly: the top-k expert indices (ties broken toward
the lower index, as ``jax.lax.top_k`` does) and, slot by slot, which
token-slots keep a place under the capacity C = ceil(g * cf * k / E) and
at which position.  Outputs are held at 1e-5 and the load-balance loss at
1e-6, absolute and relative: both sides compute in float32 and differ only
in the order of float32 sums."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as RM
from repro.configs import all_configs as r_configs
from repro.models import ParallelCtx as RCtx
from repro_torch.configs import all_configs as t_configs
from repro_torch.models import ParallelCtx as TCtx
from repro_torch.models import moe as TM
from repro_torch.models.transformer import tree_map
from torch_port_util import export_params

torch.set_num_threads(1)

OUT_TOL = 1e-5
AUX_TOL = 1e-6
R_CTX = RCtx(compute_dtype=jnp.float32)
T_CTX = TCtx(compute_dtype=torch.float32)


def _cfgs(arch="granite-moe-1b-a400m", **kw):
    return (r_configs()[arch].smoke().scaled(**kw),
            t_configs()[arch].smoke().scaled(**kw))


def _carry(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)),
                    export_params(tree))


def _x(seed, B, S, d):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _ref_keep(idx, E, C):
    """The reference's slot bookkeeping (its scatter form, written out):
    per slot, the token-slots that keep a place and their positions (C =
    the overflow bin)."""
    idx = jnp.asarray(idx)
    prev = jnp.zeros((idx.shape[0], E), jnp.int32)
    out = []
    for slot in range(idx.shape[-1]):
        e_s = idx[..., slot]
        oh = jax.nn.one_hot(e_s, E, dtype=jnp.int32)
        pos = jnp.cumsum(oh, axis=1) - oh + prev[:, None, :]
        pos_tok = jnp.take_along_axis(pos, e_s[..., None], -1)[..., 0]
        keep = pos_tok < C
        out.append((np.asarray(keep), np.asarray(jnp.where(keep, pos_tok, C))))
        prev = prev + jnp.sum(oh * keep[..., None], axis=1)
    return out


def _port_keep(idx, E, C):
    prev = torch.zeros((idx.shape[0], E), dtype=torch.long)
    out = []
    for slot in range(idx.shape[-1]):
        e_s = idx[..., slot]
        oh = TM._one_hot(e_s, E)
        pos = TM._slot_positions(oh, prev)
        pos_tok = torch.gather(pos, -1, e_s[..., None])[..., 0]
        keep = pos_tok < C
        out.append((keep.numpy(), torch.where(keep, pos_tok, C).numpy()))
        prev = prev + torch.sum(oh * keep[..., None], dim=1)
    return out


@pytest.mark.parametrize("k", [1, 2, 8])
def test_route_matches_reference_with_ties(k):
    """Top-k of soft-maxed float32 logits, ties included: equal logits on
    several experts, all tied rows, and rows tied only beyond the k-th."""
    rng = np.random.default_rng(0)
    E = 16
    logits = rng.standard_normal((3, 40, E)).astype(np.float32)
    logits[0, :5] = 0.0                                   # a row all tied
    logits[1, :, 3] = logits[1, :, 9]                     # pairs tied
    logits[2, :, ::4] = 2.5                               # a tied top group
    rv, ri = RM._route(jnp.asarray(logits), k)
    tv, ti = TM._route(torch.tensor(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    _close(tv, rv, OUT_TOL)


@pytest.mark.parametrize("tokens, group", [(48, None), (48, 16), (40, 32),
                                           (2, None), (1024, 256)])
def test_group_matches_reference(tokens, group):
    rcfg, tcfg = _cfgs()
    assert TM._group(tcfg, tokens, group) == RM._group(rcfg, tokens, group)


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_moe_layer_matches_reference(impl, cf):
    """granite smoke (4 experts, top-2, group 16): routing indices and kept
    slots identical, the layer's output 1e-5 and its aux loss 1e-6, with
    tight capacity (drops happen), the default and loose capacity."""
    rcfg, tcfg = _cfgs(capacity_factor=cf, moe_group=16, moe_impl=impl)
    p = RM.init_moe(jax.random.key(1), rcfg)
    x = _x(2, 2, 24, rcfg.d_model)
    ro, raux = RM.moe_layer(p, jnp.asarray(x), rcfg, R_CTX)
    to, taux = TM.moe_layer(_carry(p), torch.tensor(x), tcfg, T_CTX)
    _close(to, ro, OUT_TOL)
    _close(taux, raux, AUX_TOL)
    # the routing behind it, group by group
    G, g, C = TM._group(tcfg, x.shape[0] * x.shape[1], None)
    xg = x.reshape(G, g, -1)
    router = np.asarray(p["router"])
    _, ri = RM._route(jnp.asarray(xg) @ jnp.asarray(router), tcfg.top_k)
    _, ti = TM._route(torch.tensor(xg) @ torch.tensor(router), tcfg.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    kept = 0
    for (rk, rp), (tk, tp) in zip(_ref_keep(ri, tcfg.n_experts, C),
                                  _port_keep(ti, tcfg.n_experts, C)):
        np.testing.assert_array_equal(tk, rk)
        np.testing.assert_array_equal(tp, rp)
        kept += int(tk.sum())
    if cf == 0.5:
        assert kept < G * g * tcfg.top_k       # the tight case drops


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_einsum_and_scatter_agree(act):
    """The port's two dispatch forms on the same routing, drops included."""
    _, tcfg = _cfgs(capacity_factor=0.5, moe_group=16, act=act)
    p = TM.init_moe(torch.Generator().manual_seed(3), tcfg)
    x = torch.tensor(_x(4, 2, 32, tcfg.d_model))
    oe, ae = TM.moe_layer_einsum(p, x, tcfg, T_CTX)
    os_, as_ = TM.moe_layer_scatter(p, x, tcfg, T_CTX)
    _close(oe, os_.numpy(), OUT_TOL)
    assert float(ae) == float(as_)


def test_llama4_interleaved_top1_matches_reference():
    """llama4 smoke: top-1 routing over 4 experts, group 256 cut to the
    token count."""
    rcfg, tcfg = _cfgs("llama4-maverick-400b-a17b")
    p = RM.init_moe(jax.random.key(5), rcfg)
    x = _x(6, 2, 20, rcfg.d_model)
    ro, raux = RM.moe_layer(p, jnp.asarray(x), rcfg, R_CTX)
    to, taux = TM.moe_layer(_carry(p), torch.tensor(x), tcfg, T_CTX)
    _close(to, ro, OUT_TOL)
    _close(taux, raux, AUX_TOL)


def test_moe_bf16_runs_and_stays_close():
    """The serving dtype: bfloat16 compute, routing in float32.  Both sides
    round every product to bfloat16 (2^-8 relative) in their own order, so
    they are held to 2^-6 of the output's largest magnitude."""
    rcfg, tcfg = _cfgs(moe_group=16)
    p = RM.init_moe(jax.random.key(7), rcfg)
    x = _x(8, 2, 16, rcfg.d_model)
    ro, _ = RM.moe_layer(p, jnp.asarray(x, jnp.bfloat16), rcfg,
                         RCtx(compute_dtype=jnp.bfloat16))
    to, _ = TM.moe_layer(_carry(p), torch.tensor(x).bfloat16(), tcfg,
                         TCtx(compute_dtype=torch.bfloat16))
    assert to.dtype == torch.bfloat16
    want = np.asarray(ro.astype(jnp.float32))
    np.testing.assert_allclose(to.float().numpy(), want, rtol=0,
                               atol=2.0 ** -6 * np.abs(want).max())


def test_init_moe_shapes():
    _, tcfg = _cfgs()
    p = TM.init_moe(torch.Generator().manual_seed(0), tcfg)
    rp = RM.init_moe(jax.random.key(0), r_configs()[
        "granite-moe-1b-a400m"].smoke())
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in rp.items()}
