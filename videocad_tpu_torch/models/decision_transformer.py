"""Decision-transformer model family: a GPT-2 backbone over state/action
pairs.

Port of ``videocad_tpu/models/decision_transformer.py``, the model behind
``model_family: "decision_transformer"`` (``model_configs/
vid_pretrained.json``). The token stream is ``[CAD?, s_0, a_0, s_1, a_1,
...]``: the frames through the state encoder and Dense(embed -> hidden),
the actions through Dense(7 -> hidden), a learned timestep embedding added
to both streams (the only positions), the CAD image's embedding first when
``enable_image_conditioning``. Then a LayerNorm on the stacked tokens,
pre-LN GPT-2 blocks under a causal mask, a final LayerNorm, and the heads
read at the state tokens: command and parameter logits, and the tanh
action head (``continuous=True``), whose parameters exist either way so
that weights carry across.

Two things follow the JAX module rather than the rest of the port:

  * the blocks' GELU is flax ``nn.gelu``'s default, the tanh
    approximation (the ViT's is the exact erf);
  * the frames and the CAD image are preprocessed at ``maybe_preprocess``'s
    defaults (the plain path, no resize), whatever ``preprocess_impl``
    says, and the blocks' attention and dropout are the plain ones
    whatever ``attention_impl`` and ``dropout_impl`` say, in full precision
    whatever ``quant`` says. The vision encoders follow the config, as in
    JAX (``quant`` reaches a ViT encoder), and ``remat_encoder``
    recomputes the state encoder in the backward.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from videocad_tpu_torch.models.layers import (Dense, LayerNorm,
                                              MultiHeadAttention, active_rate,
                                              causal_mask)
from videocad_tpu_torch.models.videocadformer import (VideoCADFormerConfig,
                                                      check_supported,
                                                      encoder_embed_dim,
                                                      make_encoder)
from videocad_tpu_torch.ops.dropout import DropoutRng, dropout
from videocad_tpu_torch.ops.preprocess import maybe_preprocess


class GPT2Block(nn.Module):
    """Pre-LN block: LN -> causal attention -> residual, LN -> GELU (tanh)
    MLP of width 4 * model_dim -> residual, dropout on both branches."""

    def __init__(self, model_dim: int, num_heads: int,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dropout_rate = dropout_rate
        self.ln_1 = LayerNorm(model_dim, **kw)
        self.attn = MultiHeadAttention(model_dim, num_heads,
                                       dropout_rate=dropout_rate, **kw)
        self.ln_2 = LayerNorm(model_dim, **kw)
        self.mlp_in = Dense(model_dim, 4 * model_dim, **kw)
        self.mlp_out = Dense(4 * model_dim, model_dim, **kw)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        rate = active_rate(self, self.dropout_rate, rng)
        h = self.ln_1(x)
        x = x + dropout(self.attn(h, h, mask, rng), rng, rate)
        h = F.gelu(self.mlp_in(self.ln_2(x)), approximate="tanh")
        return x + dropout(self.mlp_out(h), rng, rate)


class DecisionTransformer(nn.Module):
    """forward(inputs) -> (cmd_logits (B, T, 5), param_logits (B, T, 6,
    1000)), read at the state tokens; ``continuous=True`` returns the tanh
    action head's (B, T, 7) instead."""

    def __init__(self, config: VideoCADFormerConfig, n_layer: int = 6,
                 n_head: int = 8, enable_image_conditioning: bool = True,
                 device=None):
        super().__init__()
        check_supported(config)
        self.config = cfg = config
        self.n_layer = n_layer
        self.enable_image_conditioning = enable_image_conditioning
        kw = dict(dtype=cfg.compute_dtype, device=device)
        embed = encoder_embed_dim(cfg)
        self.state_encoder = make_encoder(cfg, device,
                                          remat=cfg.remat_encoder)
        self.cad_encoder = make_encoder(cfg, device)
        self.embed_state = Dense(embed, cfg.hidden_size, **kw)
        self.embed_image = Dense(embed, cfg.hidden_size, **kw)
        self.embed_action = Dense(cfg.act_dim, cfg.hidden_size, **kw)
        self.embed_timestep = nn.Embedding(cfg.max_ep_len, cfg.hidden_size,
                                           device=device)
        self.embed_ln = LayerNorm(cfg.hidden_size, **kw)
        for i in range(n_layer):
            self.add_module(f"h_{i}", GPT2Block(
                cfg.hidden_size, n_head, cfg.dropout, **kw))
        self.ln_f = LayerNorm(cfg.hidden_size, **kw)
        self.predict_cmd = Dense(cfg.hidden_size, cfg.num_classes,
                                 device=device)
        self.predict_params = Dense(
            cfg.hidden_size, cfg.num_params * cfg.num_params_values,
            device=device)
        self.predict_action = Dense(cfg.hidden_size, cfg.act_dim,
                                    device=device)

    @property
    def device(self) -> torch.device:
        return self.predict_cmd.weight.device

    def forward(self, inputs: Dict[str, torch.Tensor],
                rng: Optional[DropoutRng] = None, continuous: bool = False):
        cfg = self.config
        dtype = cfg.compute_dtype
        frames = maybe_preprocess(inputs["frames"],
                                  bgr_as_rgb=cfg.bgr_frames_as_rgb)
        cad = maybe_preprocess(inputs["cad_image"])
        actions = inputs["actions"].to(dtype)
        b, t = actions.shape[:2]

        flat = frames.reshape((b * t,) + frames.shape[2:])
        state_emb = self.embed_state(
            self.state_encoder(flat, rng).reshape(b, t, -1))
        ts = torch.arange(t, device=self.device).clamp(0, cfg.max_ep_len - 1)
        ts_emb = self.embed_timestep.weight[ts].to(dtype)[None]
        state_emb = state_emb + ts_emb
        action_emb = self.embed_action(actions) + ts_emb

        # [CAD?, s_0, a_0, s_1, a_1, ...]
        x = torch.stack([state_emb, action_emb], dim=2).reshape(
            b, 2 * t, cfg.hidden_size)
        if self.enable_image_conditioning:
            cad_emb = self.embed_image(self.cad_encoder(cad, rng))
            x = torch.cat([cad_emb[:, None, :], x], dim=1)
        x = self.embed_ln(x)
        mask = causal_mask(x.shape[1], device=self.device)
        for i in range(self.n_layer):
            x = getattr(self, f"h_{i}")(x, mask, rng)
        x = self.ln_f(x)

        offset = 1 if self.enable_image_conditioning else 0
        # The state tokens predict the action that follows them.
        state_hidden = x[:, offset::2][:, :t].to(torch.float32)
        if continuous:
            return torch.tanh(self.predict_action(state_hidden))
        params = self.predict_params(state_hidden).reshape(
            b, t, cfg.num_params, cfg.num_params_values)
        return self.predict_cmd(state_hidden), params
