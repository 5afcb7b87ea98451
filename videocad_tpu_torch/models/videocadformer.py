"""VideoCADFormer: the autoregressive action-prediction model.

Port of ``videocad_tpu/models/videocadformer.py``:

  inputs:  UI frame history (B, T, H, W, C), past actions (B, T, 7)
           normalized, target CAD image (B, H, W, C), optional multiview
           images (B, V, H, W, C)
  outputs: command logits (B, T, 5) and parameter logits (B, T, 6, 1000)

  * per-frame vision encoding (a ViT, or ResNet18-GN under ``encoder:
    "resnet"``) -> Dense(embed -> hidden) + timestep embedding -> tanh;
  * the CAD image encoded once and broadcast over T, the multiview images
    through the same CAD encoder into one more stream; the streams
    concatenated, projected back to hidden and tanh'd;
  * action embeddings Dense(7 -> hidden) + timestep embedding -> tanh;
  * an 8-layer post-LN decoder, wired by the config's flags:
      - past actions on:  tgt=actions (causal), memory=images (banded)
      - past states only: tgt=frames, memory=CAD context (both banded)
      - neither:          tgt=memory=CAD context (banded)
  * float32 heads: Dense(hidden -> 5) and Dense(hidden -> 6*1000).

``use_pretrained_cad_model`` (GenCAD) takes the CAD input as a 256 x 256 x 3
Canny edge image (``data/dataset.py:gencad_cad_image``), normalized on all
three channels, and builds the CAD encoder for that input; training freezes
it (``train/state.py``). It cannot be combined with multiview images.

The modules' parameter names follow the JAX parameter tree, so
``models/convert.py`` carries JAX weights in by a mechanical map.

``quant`` puts the ViT encoders' and the decoder's dense layers on the int8
product (``ops/quant.py``); the embeddings, the heads and ResNet18-GN stay
in full precision, as in JAX. ``remat_encoder`` recomputes the state
encoder in the backward instead of keeping its activations, block by
block (``models/layers.py:remat``, which also redraws the forward's
dropout masks); JAX rematerializes the encoder as one region, with the
same gradients. ``frame_chunk`` encodes the frames in chunks of that many in
``eval()`` mode, where it divides B*T and is smaller, to bound the
activations of a long inference batch; JAX's condition, so training and
other sizes take the whole batch.

Split over a mesh's model axis (``parallel/sharding.py:shard_model``),
``predict_params`` is column-split (6,000 -> 3,000 float32 columns a rank
at model = 2) and its logits are gathered before the objective;
``predict_cmd`` and the embeddings stay replicated.

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
from videocad_tpu_torch.models.resnet import ResNet18GN
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


# The GenCAD CAD input: a 3-channel 256 x 256 Canny edge image.
GENCAD_IMAGE_SHAPE = (256, 256, 3)


def check_supported(cfg: VideoCADFormerConfig) -> None:
    """Raise on what JAX refuses."""
    if cfg.encoder not in ("vit", "resnet"):
        raise ValueError(f"Model type {cfg.encoder} not supported")
    if cfg.use_pretrained_cad_model and cfg.num_views > 0:
        # As the JAX model: the GenCAD encoder takes 256 x 256 x 3 edge
        # images, which frame-sized multiview renders never are.
        raise ValueError(
            "use_pretrained_cad_model (GenCAD) and num_views > 0 cannot be "
            "combined: the GenCAD CAD encoder expects 256x256x3 Canny edge "
            "images, not frame-sized multiview renders")


def encoder_embed_dim(cfg: VideoCADFormerConfig) -> int:
    """Width of the vision embedding: ``vit_dim`` for the ViT, 512 for
    ResNet18-GN whatever ``vit_dim`` is."""
    return cfg.vit_dim if cfg.encoder == "vit" else 512


def make_encoder(cfg: VideoCADFormerConfig, device=None,
                 image_size: Optional[int] = None,
                 channels: Optional[int] = None,
                 remat: bool = False) -> nn.Module:
    """The configured vision encoder, (B, H, W, C) -> (B, embed): a ViT
    at ``image_size`` with ``channels`` input channels (the config's by
    default), or ResNet18-GN (which takes any size); ``remat``: recomputed
    in the backward, block by block."""
    channels = channels or cfg.image_channels
    if cfg.encoder == "resnet":
        return ResNet18GN(channels, dtype=cfg.compute_dtype, device=device,
                          remat=remat)
    vit_cfg = ViTConfig(
        image_size=image_size or cfg.image_size, patch_size=cfg.vit_patch,
        dim=cfg.vit_dim, depth=cfg.vit_depth, heads=cfg.vit_heads,
        head_dim=cfg.vit_head_dim, mlp_dim=cfg.vit_mlp_dim,
        channels=channels, dropout=cfg.dropout, emb_dropout=cfg.dropout,
        patch_norm=cfg.vit_patch_norm, final_norm=cfg.vit_final_norm)
    return ViT(vit_cfg, dtype=cfg.compute_dtype,
               attention_impl=cfg.vit_attention_impl,
               mlp_impl=cfg.vit_mlp_impl, dropout_impl=cfg.dropout_impl,
               ln_impl=cfg.ln_impl, device=device, quant=cfg.quant,
               remat=remat)


class VideoCADFormer(nn.Module):
    """The model: teacher-forced forward, and the embedding stages the
    rollout and the serving engine drive step by step."""

    def __init__(self, config: VideoCADFormerConfig, device=None):
        super().__init__()
        check_supported(config)
        self.config = cfg = config
        dtype = cfg.compute_dtype
        kw = dict(dtype=dtype, device=device)
        embed = encoder_embed_dim(cfg)
        if cfg.enable_past_states:
            self.state_encoder = make_encoder(cfg, device,
                                              remat=cfg.remat_encoder)
            self.embed_state = Dense(embed, cfg.hidden_size, **kw)
        if cfg.use_pretrained_cad_model:
            size, _, channels = GENCAD_IMAGE_SHAPE
            self.cad_encoder = make_encoder(cfg, device, image_size=size,
                                            channels=channels)
        else:
            self.cad_encoder = make_encoder(cfg, device)
        self.embed_image = Dense(embed, cfg.hidden_size, **kw)
        if cfg.enable_past_actions:
            self.embed_action = Dense(cfg.act_dim, cfg.hidden_size, **kw)
        if cfg.num_views > 0:
            self.embed_multiview = Dense(cfg.num_views * embed,
                                         cfg.hidden_size, **kw)
        # The ui stream joins the memory only when past actions are on too
        # (the reference quirk encode_context keeps); the projection
        # exists only where streams are concatenated.
        streams = (1 + int(cfg.enable_past_states and cfg.enable_past_actions)
                   + int(cfg.num_views > 0))
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
            dropout_impl=cfg.dropout_impl, quant=cfg.quant, **kw)
        self.predict_cmd = Dense(cfg.hidden_size, cfg.num_classes,
                                 device=device)
        self.predict_params = Dense(
            cfg.hidden_size, cfg.num_params * cfg.num_params_values,
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
        frames fold into one (B*T) batch, encoded in ``frame_chunk``
        pieces in ``eval()`` mode where that divides it."""
        cfg = self.config
        frames = maybe_preprocess(frames, bgr_as_rgb=cfg.bgr_frames_as_rgb,
                                  impl=cfg.preprocess_impl,
                                  target_size=(cfg.image_size,) * 2)
        b, t = frames.shape[:2]
        flat = frames.reshape((b * t,) + frames.shape[2:])
        chunk = cfg.frame_chunk
        if (chunk and not self.training and (b * t) % chunk == 0
                and b * t > chunk):
            emb = torch.cat([self.state_encoder(piece, rng)
                             for piece in flat.split(chunk)])
        else:
            emb = self.state_encoder(flat, rng)
        return emb.reshape(b, t, -1)

    def encode_context(self, cad_image, frames=None, multiview_images=None,
                       seq_length: Optional[int] = None,
                       rng: Optional[DropoutRng] = None):
        """(combined image memory (B, T, hidden), ui embeddings or None).

        The streams in JAX's order: the ui stream (when past actions are
        on too), the CAD stream, the multiview stream; one projection when
        there are several."""
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
        constant = self._cad_streams(cad_image, multiview_images, rng)
        streams += [x[:, None, :].expand(-1, t, -1) for x in constant]
        combined = torch.cat(streams, dim=-1)
        if len(streams) > 1:
            combined = self.image_projection(combined)
        return torch.tanh(combined), ui_emb

    def _cad_streams(self, cad_image, multiview_images=None,
                     rng: Optional[DropoutRng] = None):
        """The position-independent streams, (B, hidden) each: the CAD
        image's, and the multiview images' (all views through the CAD
        encoder, one (B*V) batch) when the model has views and they are
        given."""
        cfg = self.config
        if cfg.use_pretrained_cad_model:
            # The edge image: all three channels normalized, no grayscale.
            cad_image = maybe_preprocess(cad_image, impl=cfg.preprocess_impl,
                                         mode="normalize_only")
        else:
            cad_image = maybe_preprocess(cad_image, impl=cfg.preprocess_impl,
                                         target_size=(cfg.image_size,) * 2)
        streams = [self.embed_image(self.cad_encoder(cad_image, rng))]
        if multiview_images is not None and cfg.num_views > 0:
            views = maybe_preprocess(multiview_images,
                                     impl=cfg.preprocess_impl,
                                     target_size=(cfg.image_size,) * 2)
            b, v = views.shape[:2]
            emb = self.cad_encoder(views.reshape((b * v,) + views.shape[2:]),
                                   rng)
            streams.append(self.embed_multiview(emb.reshape(b, -1)))
        return streams

    def encode_cad_stream(self, cad_image: torch.Tensor,
                          multiview_images: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """The position-independent CAD features that ``encode_context``
        tiles over T: (B, hidden), or (B, 2 * hidden) with multiview
        images, in ``encode_context``'s stream order. Computed once per
        serving session."""
        return torch.cat(self._cad_streams(cad_image, multiview_images),
                         dim=-1)

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
        if hasattr(self, "image_projection"):
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
            inputs["cad_image"], inputs.get("frames"),
            inputs.get("multiview_images"), seq_length, rng)
        # The flash attention kernels compute both masks from indices.
        by_index = cfg.attention_impl == "pallas"
        band = banded_mask(seq_length, seq_length, cfg.window_size,
                           device=self.device, by_index=by_index)
        if cfg.enable_past_actions:
            hidden = self.decoder(self.embed_actions(actions), combined,
                                  tgt_mask=causal_mask(seq_length,
                                                       device=self.device,
                                                       by_index=by_index),
                                  memory_mask=band, rng=rng)
        elif cfg.enable_past_states:
            hidden = self.decoder(ui_emb, combined, tgt_mask=band,
                                  memory_mask=band, rng=rng)
        else:
            hidden = self.decoder(combined, combined, tgt_mask=band,
                                  memory_mask=band, rng=rng)
        return self.heads(hidden)
