"""Model API of the port, over the reference's parameter layout.

    model = build_model(cfg, ctx, device=None)        # the card by default
    params = model.init(generator)                    # explicit torch.Generator
    logits, aux = model.forward(params, batch)        # train / score
    cache = model.init_cache(B, max_len)
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.decode_step(params, cache, tokens, positions)

``Model`` is a plain class over a parameter dict, not an ``nn.Module``:
the parameters keep the reference's tree (``{"embed", "stack": {"blocks",
"rem"}, "final_norm"[, "lm_head"]}``, superblocks stacked on a leading
axis), so weights carry across from the reference leaf for leaf
(``repro_torch.interop.params_from_numpy``), and the functions that apply
them stay the reference's functions.  An encoder-decoder model adds
``"encoder"`` (a stack of ``"enc"`` layers) and ``"enc_norm"``.  Nothing
here trains yet.

``batch`` is a dict holding ``tokens`` (B, S) and, for the modality
stubs, ``patches`` (B, n_patches, d) -- a vision model's precomputed
patch embeddings, written over the first ``min(n_patches, S)`` positions
-- or ``frames`` (B, src_seq, d) -- an audio encoder-decoder's precomputed
frame embeddings, run through the encoder stack (``"enc"`` layers,
unmasked) whose output every decoder layer cross-attends to.  Other keys
are ignored, as in the reference.

Device rule: everything lives on the CUDA device unless the model was
built with ``device="cpu"``; without CUDA and without that request,
``init`` / ``init_cache`` / the entry points raise.  Caches are updated in
place.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from . import transformer as tf
from .layers import ParallelCtx, embed, init_embedding, init_norm, rms_norm, unembed


class Model:
    def __init__(self, cfg: ModelConfig, ctx: Optional[ParallelCtx] = None,
                 device: DeviceLike = None) -> None:
        self.cfg = cfg
        self.ctx = ctx or ParallelCtx()
        self._device_req = device
        self.sm = tf.stack_meta(cfg)
        self.enc_sm = (tf.stack_meta(cfg, n_layers=cfg.encoder_layers,
                                     pattern_override=("enc",))
                       if cfg.is_encdec else None)

    @property
    def device(self) -> torch.device:
        return resolve_device(self._device_req)

    # -- params ---------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        """Random fp32 parameters drawn from ``generator``, which must live
        on the model's device."""
        dev = self.device
        if torch.device(generator.device).type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on {dev}")
        cfg = self.cfg
        params = {
            "embed": init_embedding(generator, cfg.vocab, cfg.d_model, dev),
            "stack": tf.init_stack(generator, cfg, self.sm, dev),
            "final_norm": init_norm(cfg.d_model, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = init_embedding(generator, cfg.vocab,
                                               cfg.d_model, dev)
        if cfg.is_encdec:
            params["encoder"] = tf.init_stack(generator, cfg, self.enc_sm, dev)
            params["enc_norm"] = init_norm(cfg.d_model, dev)
        return params

    # -- shared pieces ----------------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed_inputs(self, params, batch) -> torch.Tensor:
        cfg, ctx = self.cfg, self.ctx
        x = embed(self._tokens(batch["tokens"]), params["embed"],
                  ctx.compute_dtype, ctx)
        if cfg.frontend == "vision" and "patches" in batch:
            n = min(cfg.n_patches, x.shape[1])
            patches = torch.as_tensor(batch["patches"], device=x.device)
            x[:, :n] = patches[:, :n].to(x.dtype)
        return ctx.rows(x)

    def _encode(self, params, batch) -> Optional[torch.Tensor]:
        if not self.cfg.is_encdec:
            return None
        frames = torch.as_tensor(batch["frames"], device=self.device).to(
            self.ctx.compute_dtype)
        pos = torch.arange(frames.shape[1], device=frames.device)
        h, _, _ = tf.apply_stack(params["encoder"], frames, self.cfg, self.ctx,
                                 self.enc_sm, pos)
        return rms_norm(h, params["enc_norm"], self.cfg.norm_eps)

    def _logits(self, params, x) -> torch.Tensor:
        table = self.ctx.weight(params.get("lm_head", params["embed"]), x,
                                x.dtype)
        return unembed(x, table, self.cfg.final_softcap)

    # -- entry points -------------------------------------------------------------
    def forward(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Training/scoring forward. Returns (logits (B,S,V) fp32, aux)."""
        cfg, ctx = self.cfg, self.ctx
        x = self._embed_inputs(params, batch)
        enc_out = self._encode(params, batch)
        pos = torch.arange(x.shape[1], device=x.device)
        x, aux, _ = tf.apply_stack(params["stack"], x, cfg, ctx, self.sm, pos,
                                   enc_out=enc_out)
        x = ctx.rows(rms_norm(x, params["final_norm"], cfg.norm_eps))
        return self._logits(params, x), aux

    def init_cache(self, B: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        return tf.init_stack_cache(self.cfg, self.sm, B, max_len, dtype,
                                   self.device)

    def prefill(self, params, batch, cache) -> tuple[torch.Tensor, dict]:
        """Run S prompt tokens, filling the decode cache in place.
        Returns (last-position logits (B,V), cache)."""
        cfg, ctx = self.cfg, self.ctx
        x = self._embed_inputs(params, batch)
        enc_out = self._encode(params, batch)
        pos = torch.arange(x.shape[1], device=x.device)
        x, _, cache = tf.apply_stack(params["stack"], x, cfg, ctx, self.sm,
                                     pos, enc_out=enc_out, cache=cache)
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        return self._logits(params, x)[:, 0], cache

    def decode_step(self, params, cache, tokens, positions,
                    batch: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
        """One decode step. tokens (B,1), positions (B,) integers.
        Returns (logits (B,V) fp32, cache updated in place)."""
        cfg, ctx = self.cfg, self.ctx
        x = ctx.rows(embed(self._tokens(tokens), params["embed"],
                           ctx.compute_dtype, ctx))
        x, cache = tf.apply_stack_decode(params["stack"], x, cache, cfg, ctx,
                                         self.sm, self._tokens(positions))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x)[:, 0], cache


def build_model(cfg: ModelConfig, ctx: Optional[ParallelCtx] = None,
                device: DeviceLike = None) -> Model:
    return Model(cfg, ctx, device)
