"""The port's encoder-decoder pieces and modality frontends against the
reference package's, on carried weights and the same seeded numpy inputs,
float32 on the CPU: the ``"enc"`` attention layer (unmasked) on both of the
port's routes, ``_cross_attention`` / ``_cross_decode``, the ``patches``
overlay and ``frames`` through ``_encode``, and the serving engine on the
new families, as the reference's engine runs them (prefill by decode; for
whisper, no frames and the all-zero ``cross_kv`` of ``init_layer_cache``).

Modules at 1e-5, models at 1e-4, absolute and relative (float32 sums in
another order); served tokens (argmaxes) identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as RL
import repro.models.transformer as RT
from repro.configs import all_configs as r_configs
from repro.configs import shapes as r_shapes
from repro.models import ParallelCtx as RCtx, build_model as r_build
from repro.serve.engine import Request as RRequest, ServeEngine as RServe
import repro_torch.launch.serve as t_serve
from repro_torch.configs import all_configs as t_configs
from repro_torch.configs import shapes as t_shapes
from repro_torch.interop import params_from_numpy
from repro_torch.models import ParallelCtx as TCtx, build_model as t_build
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import tree_map
from repro_torch.serve.engine import Request as TRequest, ServeEngine as TServe
from torch_port_util import export_params

torch.set_num_threads(1)

MODULE_TOL = 1e-5
MODEL_TOL = 1e-4
R_CTX = RCtx(compute_dtype=jnp.float32, flash_threshold=1 << 30)
WHISPER = "whisper-large-v3"
PHI3V = "phi-3-vision-4.2b"


def t_ctx(use_kernels: bool = True) -> TCtx:
    return TCtx(compute_dtype=torch.float32, use_kernels=use_kernels)


def carry(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)),
                    export_params(tree))


def close(got, want, tol=MODULE_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def randn(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the encoder layer and cross-attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("S", [24, 37])
def test_enc_attention_layer_is_unmasked(S, use_kernels):
    """whisper smoke ("enc": rope, no mask) against the reference, and
    against the port's own causal layer, which it must not equal."""
    cfg = r_configs()[WHISPER].smoke()
    p = RL.init_attention(jax.random.key(1), cfg)
    x = randn(2, 2, S, cfg.d_model)
    pos = np.arange(S)
    want = RL.attention_layer(p, jnp.asarray(x), cfg, R_CTX, "enc",
                              jnp.asarray(pos))
    got = TL.attention_layer(carry(p), torch.tensor(x), cfg,
                             t_ctx(use_kernels), "enc", torch.tensor(pos))
    close(got, want)
    causal = TL.attention_layer(carry(p), torch.tensor(x), cfg,
                                t_ctx(use_kernels), "global",
                                torch.tensor(pos))
    assert not np.allclose(causal.numpy(), np.asarray(want), atol=1e-3)


def test_enc_layer_with_reference_pallas_unmasked():
    """The port's kernel route (B5's plain version, causal=False) against
    the reference's Pallas kernel in interpret mode, via the layer."""
    cfg = r_configs()[WHISPER].smoke()
    p = RL.init_attention(jax.random.key(3), cfg)
    x = randn(4, 2, 32, cfg.d_model)
    pos = np.arange(32)
    want = RL.attention_layer(p, jnp.asarray(x), cfg,
                              RCtx(compute_dtype=jnp.float32,
                                   use_kernels=True), "enc", jnp.asarray(pos))
    got = TL.attention_layer(carry(p), torch.tensor(x), cfg, t_ctx(True),
                             "enc", torch.tensor(pos))
    close(got, want)


def test_cross_attention_matches_reference():
    """Decoder queries (S = 9) over encoder keys (24 frames): no mask, no
    rope; the keys and values it returns for the decode cache."""
    cfg = r_configs()[WHISPER].smoke()
    p = RL.init_attention(jax.random.key(5), cfg)
    x = randn(6, 2, 9, cfg.d_model)
    enc = randn(7, 2, cfg.src_seq, cfg.d_model)
    ro, rkv = RT._cross_attention(p, jnp.asarray(x), jnp.asarray(enc), cfg,
                                  R_CTX)
    to, tkv = TT._cross_attention(carry(p), torch.tensor(x),
                                  torch.tensor(enc), cfg, t_ctx())
    close(to, ro)
    close(tkv["k"], rkv["k"])
    close(tkv["v"], rkv["v"])


@pytest.mark.parametrize("zero_kv", [False, True])
def test_cross_decode_matches_reference(zero_kv):
    """One decode query over a cross-kv cache: filled, and all zero (what
    the serving engine's decoder sees, the reference's as the port's)."""
    cfg = r_configs()[WHISPER].smoke()
    p = RL.init_attention(jax.random.key(8), cfg)
    x = randn(9, 3, 1, cfg.d_model)
    shape = (3, cfg.src_seq, cfg.n_kv, cfg.hd)
    kv = ({"k": np.zeros(shape, np.float32), "v": np.zeros(shape, np.float32)}
          if zero_kv else {"k": randn(10, *shape), "v": randn(11, *shape)})
    want = RT._cross_decode(p, jnp.asarray(x),
                            {n: jnp.asarray(a) for n, a in kv.items()},
                            cfg, R_CTX)
    got = TT._cross_decode(carry(p), torch.tensor(x),
                           {n: torch.tensor(a) for n, a in kv.items()},
                           cfg, t_ctx())
    close(got, want)


def test_layer_caches_match_reference_layout():
    """init_layer_cache for every kind, with and without cross-attention:
    the same keys, shapes and dtypes, zero-filled."""
    for arch in (WHISPER, "rwkv6-1.6b", "granite-moe-1b-a400m"):
        cfg = r_configs()[arch].smoke()
        for meta in RT.stack_meta(cfg).metas:
            want = RT.init_layer_cache(cfg, meta, 2, 16, jnp.float32)
            got = TT.init_layer_cache(cfg, meta, 2, 16, torch.float32)
            pairs = []
            tree_map(lambda a, b: pairs.append((a, b)), got,
                     jax.tree.map(np.asarray, want))
            assert pairs
            for a, b in pairs:
                assert tuple(a.shape) == b.shape and not a.any()
                assert str(a.dtype).split(".")[-1] == str(b.dtype)


# ---------------------------------------------------------------------------
# frontends
# ---------------------------------------------------------------------------
def _models(arch):
    cfg = r_configs()[arch].smoke()
    rmodel = r_build(cfg, R_CTX)
    rparams = rmodel.init(jax.random.key(0))
    tcfg = t_configs()[arch].smoke()
    tmodel = t_build(tcfg, t_ctx(), device="cpu")
    tparams = params_from_numpy(tcfg, export_params(rparams), device="cpu")
    return cfg, rmodel, rparams, tmodel, tparams


@pytest.mark.parametrize("S", [5, 20])
def test_patches_overlay_first_positions(S):
    """phi-3-vision smoke (8 patch positions): patches written over the
    first min(8, S) embedded positions, the rest the tokens' embeddings;
    the forward logits follow."""
    cfg, rmodel, rparams, tmodel, tparams = _models(PHI3V)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, S))
    patches = randn(2, 2, cfg.n_patches, cfg.d_model)
    rb = {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)}
    tb = {"tokens": torch.tensor(toks), "patches": torch.tensor(patches)}
    rx = rmodel._embed_inputs(rparams, rb)
    tx = tmodel._embed_inputs(tparams, tb)
    close(tx, rx)
    n = min(cfg.n_patches, S)
    close(tx[:, :n], patches[:, :n])
    plain = tmodel._embed_inputs(tparams, {"tokens": torch.tensor(toks)})
    close(tx[:, n:], plain[:, n:].numpy())
    close(tmodel.forward(tparams, tb)[0], rmodel.forward(rparams, rb)[0],
          MODEL_TOL)


def test_frames_through_encode():
    """whisper smoke: frames (B, src_seq, d) through the two "enc" layers
    and the encoder norm, against the reference's ``_encode``; a model
    without an encoder gives None."""
    cfg, rmodel, rparams, tmodel, tparams = _models(WHISPER)
    frames = randn(3, 2, cfg.src_seq, cfg.d_model)
    want = rmodel._encode(rparams, {"frames": jnp.asarray(frames)})
    got = tmodel._encode(tparams, {"frames": torch.tensor(frames)})
    assert tuple(got.shape) == (2, cfg.src_seq, cfg.d_model)
    close(got, want, MODEL_TOL)
    other = t_build(t_configs()["gemma3-1b"].smoke(), device="cpu")
    assert other._encode({}, {"frames": torch.tensor(frames)}) is None


def test_decoder_depends_on_frames():
    """The same tokens with negated frames give other logits (the decoder
    reads the encoder through cross-attention), as in the reference."""
    cfg, _, _, tmodel, tparams = _models(WHISPER)
    toks = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab,
                                                          (2, 10)))
    frames = torch.tensor(randn(5, 2, cfg.src_seq, cfg.d_model))
    a, _ = tmodel.forward(tparams, {"tokens": toks, "frames": frames})
    b, _ = tmodel.forward(tparams, {"tokens": toks, "frames": -frames})
    assert not torch.allclose(a, b, atol=1e-3)


# ---------------------------------------------------------------------------
# serving the new families, as the reference engine does
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-1.6b",
                                  WHISPER, PHI3V])
def test_serve_engine_matches_reference(arch):
    """Five requests over two slots: the same tokens and slot counters."""
    cfg, rmodel, rparams, tmodel, tparams = _models(arch)
    reng = RServe(rmodel, rparams, max_slots=2, max_len=16)
    teng = TServe(tmodel, tparams, max_slots=2, max_len=16)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, size=rng.integers(2, 6)).astype(
        np.int32) for _ in range(5)]
    rdone = reng.run([RRequest(i, p, max_new=4) for i, p in enumerate(prompts)])
    tdone = teng.run([TRequest(i, p, max_new=4) for i, p in enumerate(prompts)])
    assert {r.rid: r.out for r in tdone} == {r.rid: r.out for r in rdone}
    for attr in ("admitted_total", "slot_rejections", "_tokens_decoded"):
        assert getattr(teng, attr) == getattr(reng, attr), attr


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", WHISPER])
def test_serve_main_runs_new_families_on_cpu(arch, capsys):
    argv = ["--arch", arch, "--requests", "3", "--slots", "2",
            "--max-new", "2", "--max-len", "16", "--smoke", "--device", "cpu"]
    report = t_serve.run(t_serve.parse_args(argv))
    assert len(report.done) == 3 and report.tokens == 6
    assert "[serve] 3 requests, 6 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# configs/shapes.py
# ---------------------------------------------------------------------------
def test_shapes_and_cells_match_reference():
    assert t_shapes.SHAPES == {k: t_shapes.Shape(**vars(v))
                               for k, v in r_shapes.SHAPES.items()}
    assert t_shapes.cells() == r_shapes.cells()
    assert t_shapes.cells(include_skipped=True) == r_shapes.cells(
        include_skipped=True)


@pytest.mark.parametrize("shape", sorted(r_shapes.SHAPES))
def test_input_specs_match_reference(shape):
    """Every config's data-input specs: the same names, shapes and dtypes
    (the frontends' frames / patches included)."""
    for arch in sorted(r_configs()):
        want = r_shapes.input_specs(r_configs()[arch],
                                    r_shapes.SHAPES[shape])
        got = t_shapes.input_specs(t_configs()[arch], t_shapes.SHAPES[shape])
        assert sorted(got) == sorted(want), arch
        for name, spec in got.items():
            assert spec.shape == tuple(want[name].shape), (arch, name)
            assert str(spec.dtype).split(".")[-1] == str(want[name].dtype)
    with pytest.raises(Exception):
        got["tokens"].shape = (1,)           # frozen
