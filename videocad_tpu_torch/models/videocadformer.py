"""VideoCADFormer: the autoregressive action-prediction model.

Port of ``videocad_tpu/models/videocadformer.py``:

  inputs:  UI frame history (B, T, H, W, C), past actions (B, T, 7)
           normalized, target CAD image (B, H, W, C)
  outputs: command logits (B, T, 5) and parameter logits (B, T, 6, 1000)

  * per-frame ViT encoding -> Dense(512 -> hidden) + timestep embedding
    -> tanh;
  * the CAD image encoded once and broadcast over T; the streams
    concatenated, projected back to hidden and tanh'd;
  * action embeddings Dense(7 -> hidden) + timestep embedding -> tanh;
  * an 8-layer post-LN decoder, wired by the config's flags:
      - past actions on:  tgt=actions (causal), memory=images (banded)
      - past states only: tgt=frames, memory=CAD context (both banded)
      - neither:          tgt=memory=CAD context (banded)
  * float32 heads: Dense(hidden -> 5) and Dense(hidden -> 6*1000).

The modules' parameter names follow the JAX parameter tree, so
``models/convert.py`` carries JAX weights in by a mechanical map. Options
the port has not reached yet raise ``NotImplementedError`` naming the
ROADMAP item that brings them.

Dropout is active in ``train()`` mode only, at every site the JAX modules
have, and draws from the ``rng`` argument of ``forward`` (a
:class:`~videocad_tpu_torch.ops.dropout.DropoutRng`); ``eval()`` mode
needs none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from videocad_tpu_torch.actions.vocab import (ACT_DIM, NUM_BINS, NUM_COMMANDS,
                                              NUM_PARAMS)
from videocad_tpu_torch.models.layers import (Dense, TransformerDecoder,
                                              banded_mask, causal_mask)
from videocad_tpu_torch.models.vit import ViT, ViTConfig
from videocad_tpu_torch.ops.dropout import DropoutRng
from videocad_tpu_torch.ops.preprocess import maybe_preprocess


@dataclasses.dataclass(frozen=True)
class VideoCADFormerConfig:
    act_dim: int = ACT_DIM
    hidden_size: int = 1024
    num_classes: int = NUM_COMMANDS
    num_params: int = NUM_PARAMS
    num_params_values: int = NUM_BINS
    num_decoder_layers: int = 8
    dim_feedforward: int = 1024
    nhead: int = 4
    dropout: float = 0.1
    encoder: str = "vit"
    enable_past_actions: bool = False
    enable_past_states: bool = False
    enable_timestep_embedding: bool = False
    num_views: int = 0
    window_size: int = 1
    max_ep_len: int = 1000
    use_pretrained_cad_model: bool = False
    image_channels: int = 1
    image_size: int = 224
    vit_patch: int = 32
    vit_dim: int = 512
    vit_depth: int = 6
    vit_heads: int = 16
    vit_head_dim: int = 64
    vit_mlp_dim: int = 512
    vit_patch_norm: bool = True
    vit_final_norm: bool = True
    dtype: str = "float32"
    attention_impl: str = "xla"
    vit_attention_impl: str = "xla"
    vit_mlp_impl: str = "xla"
    ln_impl: str = "xla"
    dropout_impl: str = "xla"
    quant: str = "none"
    preprocess_impl: str = "xla"
    frame_chunk: int = 0
    remat_encoder: bool = False
    bgr_frames_as_rgb: bool = True

    @staticmethod
    def from_json(config: Dict[str, Any]) -> "VideoCADFormerConfig":
        """Build from a ``model_configs/*.json`` entry (unknown keys are
        tolerated, as in the JAX package)."""
        fields = {f.name for f in dataclasses.fields(VideoCADFormerConfig)}
        if config.get("window_size", 1) <= 0:
            raise ValueError("Window size must be > 0")
        return VideoCADFormerConfig(
            **{k: v for k, v in config.items() if k in fields})

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def _check_supported(cfg: VideoCADFormerConfig) -> None:
    unported = [
        (cfg.encoder != "vit", f"encoder={cfg.encoder!r} (ROADMAP slice 11)"),
        (cfg.num_views > 0, "num_views > 0 (ROADMAP slice 11)"),
        (cfg.use_pretrained_cad_model,
         "use_pretrained_cad_model (ROADMAP slice 11)"),
        (cfg.attention_impl == "pallas",
         "attention_impl='pallas' (ROADMAP kernel K3)"),
        (cfg.quant != "none", f"quant={cfg.quant!r} (ROADMAP slice 11)"),
        (cfg.frame_chunk != 0, "frame_chunk (ROADMAP slice 11)"),
        (cfg.remat_encoder, "remat_encoder (ROADMAP slice 11)"),
    ]
    missing = [what for bad, what in unported if bad]
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


class VideoCADFormer(nn.Module):
    """The model: teacher-forced forward, and the embedding stages the
    rollout and the serving engine drive step by step."""

    def __init__(self, config: VideoCADFormerConfig, device=None):
        super().__init__()
        _check_supported(config)
        self.config = cfg = config
        dtype = cfg.compute_dtype
        kw = dict(dtype=dtype, device=device)
        if cfg.enable_past_states:
            self.state_encoder = self._make_encoder(device)
            self.embed_state = Dense(cfg.vit_dim, cfg.hidden_size, **kw)
        self.cad_encoder = self._make_encoder(device)
        self.embed_image = Dense(cfg.vit_dim, cfg.hidden_size, **kw)
        if cfg.enable_past_actions:
            self.embed_action = Dense(cfg.act_dim, cfg.hidden_size, **kw)
        # The ui stream joins the memory only when past actions are on too
        # (the reference quirk encode_context keeps); the projection
        # exists only where streams are concatenated.
        streams = 1 + int(cfg.enable_past_states and cfg.enable_past_actions)
        if streams > 1:
            self.image_projection = Dense(streams * cfg.hidden_size,
                                          cfg.hidden_size, **kw)
        if cfg.enable_timestep_embedding:
            self.timestep_embedding = nn.Embedding(
                cfg.max_ep_len, cfg.hidden_size, device=device)
        self.decoder = TransformerDecoder(
            cfg.hidden_size, cfg.num_decoder_layers, cfg.nhead,
            cfg.dim_feedforward, dropout_rate=cfg.dropout,
            attention_impl=cfg.attention_impl,
            dropout_impl=cfg.dropout_impl, **kw)
        self.predict_cmd = Dense(cfg.hidden_size, cfg.num_classes,
                                 device=device)
        self.predict_params = Dense(
            cfg.hidden_size, cfg.num_params * cfg.num_params_values,
            device=device)

    def _make_encoder(self, device) -> ViT:
        cfg = self.config
        vit_cfg = ViTConfig(
            image_size=cfg.image_size, patch_size=cfg.vit_patch,
            dim=cfg.vit_dim, depth=cfg.vit_depth, heads=cfg.vit_heads,
            head_dim=cfg.vit_head_dim, mlp_dim=cfg.vit_mlp_dim,
            channels=cfg.image_channels, dropout=cfg.dropout,
            emb_dropout=cfg.dropout, patch_norm=cfg.vit_patch_norm,
            final_norm=cfg.vit_final_norm)
        return ViT(vit_cfg, dtype=cfg.compute_dtype,
                   attention_impl=cfg.vit_attention_impl,
                   mlp_impl=cfg.vit_mlp_impl,
                   dropout_impl=cfg.dropout_impl, ln_impl=cfg.ln_impl,
                   device=device)

    @property
    def device(self) -> torch.device:
        return self.predict_cmd.weight.device

    # ---- embedding stages (shared by the forward and the rollout) ----

    def _timestep(self, t: torch.Tensor) -> torch.Tensor:
        """Timestep embedding rows for positions ``t``, compute dtype."""
        cfg = self.config
        if cfg.enable_timestep_embedding:
            t = t.clamp(0, cfg.max_ep_len - 1)
            return self.timestep_embedding.weight[t].to(cfg.compute_dtype)
        return torch.zeros(tuple(t.shape) + (cfg.hidden_size,),
                           dtype=cfg.compute_dtype, device=t.device)

    def encode_frames(self, frames: torch.Tensor,
                      rng: Optional[DropoutRng] = None) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, T, vit_dim) via the state encoder; the
        frames fold into one (B*T) batch."""
        cfg = self.config
        frames = maybe_preprocess(frames, bgr_as_rgb=cfg.bgr_frames_as_rgb,
                                  impl=cfg.preprocess_impl,
                                  target_size=(cfg.image_size,) * 2)
        b, t = frames.shape[:2]
        emb = self.state_encoder(
            frames.reshape((b * t,) + frames.shape[2:]), rng)
        return emb.reshape(b, t, -1)

    def encode_context(self, cad_image, frames=None,
                       seq_length: Optional[int] = None,
                       rng: Optional[DropoutRng] = None):
        """(combined image memory (B, T, hidden), ui embeddings or None)."""
        cfg = self.config
        t = seq_length if seq_length is not None else frames.shape[1]
        ts_emb = self._timestep(torch.arange(t, device=self.device))
        ui_emb = None
        streams = []
        if cfg.enable_past_states:
            state_emb = self.encode_frames(frames, rng)
            ui_emb = torch.tanh(self.embed_state(state_emb) + ts_emb[None])
            if cfg.enable_past_actions:
                streams.append(ui_emb)
        cad_emb = self.embed_image(self._encode_cad(cad_image, rng))
        cad_emb = cad_emb[:, None, :]
        streams.append(cad_emb.expand(-1, t, -1))
        combined = torch.cat(streams, dim=-1)
        if len(streams) > 1:
            combined = self.image_projection(combined)
        return torch.tanh(combined), ui_emb

    def _encode_cad(self, cad_image: torch.Tensor,
                    rng: Optional[DropoutRng] = None) -> torch.Tensor:
        cfg = self.config
        cad_image = maybe_preprocess(cad_image, impl=cfg.preprocess_impl,
                                     target_size=(cfg.image_size,) * 2)
        return self.cad_encoder(cad_image, rng)

    def encode_cad_stream(self, cad_image: torch.Tensor) -> torch.Tensor:
        """The position-independent CAD features that ``encode_context``
        tiles over T: (B, hidden). Computed once per serving session."""
        return self.embed_image(self._encode_cad(cad_image))

    def encode_memory_step(self, frame: torch.Tensor, t: torch.Tensor,
                           cad_stream: torch.Tensor) -> torch.Tensor:
        """One memory position for incremental decode: (B, hidden).

        ``frame``: (B, H, W, C), the newly observed UI frame; ``t``: a
        scalar or per-row (B,) position; ``cad_stream``: the output of
        ``encode_cad_stream``.
        """
        cfg = self.config
        streams = []
        if cfg.enable_past_states and cfg.enable_past_actions:
            emb = self.encode_frames(frame[:, None])[:, 0]
            ts = self._timestep(torch.as_tensor(t, device=self.device))
            streams.append(torch.tanh(self.embed_state(emb) + ts))
        streams.append(cad_stream)
        combined = torch.cat(streams, dim=-1)
        if len(streams) > 1:
            combined = self.image_projection(combined)
        return torch.tanh(combined)

    def embed_actions(self, actions: torch.Tensor) -> torch.Tensor:
        """(B, T, 7) normalized float actions -> (B, T, hidden)."""
        ts_emb = self._timestep(torch.arange(actions.shape[1],
                                             device=self.device))
        return torch.tanh(self.embed_action(actions) + ts_emb[None])

    def heads(self, hidden: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t = hidden.shape[:2]
        hidden = hidden.to(torch.float32)
        params = self.predict_params(hidden)
        return self.predict_cmd(hidden), params.reshape(
            b, t, self.config.num_params, self.config.num_params_values)

    # ---- full-sequence (teacher-forced) forward ----

    def forward(self, inputs: Dict[str, torch.Tensor],
                rng: Optional[DropoutRng] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        actions = inputs["actions"]
        seq_length = actions.shape[1]
        combined, ui_emb = self.encode_context(
            inputs["cad_image"], inputs.get("frames"), seq_length, rng)
        band = banded_mask(seq_length, seq_length, cfg.window_size,
                           device=self.device)
        if cfg.enable_past_actions:
            hidden = self.decoder(self.embed_actions(actions), combined,
                                  tgt_mask=causal_mask(seq_length,
                                                       device=self.device),
                                  memory_mask=band, rng=rng)
        elif cfg.enable_past_states:
            hidden = self.decoder(ui_emb, combined, tgt_mask=band,
                                  memory_mask=band, rng=rng)
        else:
            hidden = self.decoder(combined, combined, tgt_mask=band,
                                  memory_mask=band, rng=rng)
        return self.heads(hidden)
