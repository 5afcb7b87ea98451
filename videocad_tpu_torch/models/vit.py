"""Vision Transformer encoder for UI frames and CAD images.

Port of ``videocad_tpu/models/vit.py`` (the reference's vit_pytorch
configuration: image 224, patch 32, dim 512, depth 6, 16 heads of 64, mlp
512, CLS pooling). Patches are cut by reshape in NHWC order, then
LayerNorm -> Dense -> LayerNorm (behind ``patch_norm``), a cls token and
position embedding, pre-LN blocks with exact erf GELU, a final LayerNorm
(behind ``final_norm``), and the CLS row as the embedding.

``attention_impl="fused"`` runs each block's attention core through the
hand-written ``mhsa_short`` kernels (the flagship's setting). In ``train()``
mode dropout runs on the embedding, on each block's attention output and
two MLP sites, and on the attention weights (inside the fused kernel); the
``rng`` argument of ``forward`` feeds them (``models/layers.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from videocad_tpu_torch.models.layers import (Dense, LayerNorm,
                                              MultiHeadAttention, active_rate)
from videocad_tpu_torch.ops.dropout import DropoutRng, dropout


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 32
    dim: int = 512
    depth: int = 6
    heads: int = 16
    head_dim: int = 64
    mlp_dim: int = 512
    channels: int = 1
    dropout: float = 0.1
    emb_dropout: float = 0.1
    # vit_pytorch checkpoint generations: the legacy ViT has no LayerNorms
    # around the patch projection and no final transformer norm.
    patch_norm: bool = True
    final_norm: bool = True


def _check_impls(attention_impl: str, mlp_impl: str, ln_impl: str) -> None:
    if ln_impl != "xla":
        raise NotImplementedError(
            f"ln_impl={ln_impl!r} needs the LayerNorm kernel, not ported "
            "yet (ROADMAP kernel K4)")
    if attention_impl == "block" or mlp_impl == "block":
        raise NotImplementedError(
            "vit_attention_impl / vit_mlp_impl 'block' need the fused "
            "block kernels, not ported yet (ROADMAP kernel K6)")
    if attention_impl not in ("xla", "fused") or mlp_impl != "xla":
        raise ValueError(f"unknown ViT impls: attention {attention_impl!r}, "
                         f"mlp {mlp_impl!r}")


class ViTBlock(nn.Module):
    """One pre-LN transformer block."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype,
                 attention_impl: str = "xla", device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attn_norm = LayerNorm(cfg.dim, **kw)
        self.mlp_norm = LayerNorm(cfg.dim, **kw)
        self.dropout_rate = cfg.dropout
        self.attn = MultiHeadAttention(cfg.dim, cfg.heads,
                                       head_dim=cfg.head_dim,
                                       dropout_rate=cfg.dropout,
                                       qkv_bias=False,
                                       attention_impl=attention_impl, **kw)
        self.mlp_in = Dense(cfg.dim, cfg.mlp_dim, **kw)
        self.mlp_out = Dense(cfg.mlp_dim, cfg.dim, **kw)

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        rate = active_rate(self, self.dropout_rate, rng)
        bits = rng.bits if rate > 0.0 else None
        h = self.attn_norm(x)
        x = x + dropout(self.attn(h, h, rng=rng), bits, rate)
        h = self.mlp_in(self.mlp_norm(x))
        # exact erf GELU (torch nn.GELU default, as the reference)
        h = self.mlp_out(dropout(F.gelu(h), bits, rate))
        return x + dropout(h, bits, rate)


class ViT(nn.Module):
    """ViT encoder: (B, H, W, C) image -> (B, dim) CLS embedding."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "xla", mlp_impl: str = "xla",
                 ln_impl: str = "xla", device=None):
        super().__init__()
        _check_impls(attention_impl, mlp_impl, ln_impl)
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        p = cfg.patch_size
        grid = cfg.image_size // p
        patch_dim = p * p * cfg.channels
        if cfg.patch_norm:
            self.patch_norm_in = LayerNorm(patch_dim, **kw)
        self.patch_embed = Dense(patch_dim, cfg.dim, **kw)
        if cfg.patch_norm:
            self.patch_norm_out = LayerNorm(cfg.dim, **kw)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.dim,
                                                  device=device))
        self.pos_embedding = nn.Parameter(
            torch.empty(1, grid * grid + 1, cfg.dim, device=device))
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", ViTBlock(
                cfg, dtype, attention_impl=attention_impl, device=device))
        if cfg.final_norm:
            self.final_norm = LayerNorm(cfg.dim, **kw)

    def forward(self, images: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        cfg = self.cfg
        b, h, w, c = images.shape
        p = cfg.patch_size
        gh, gw = h // p, w // p
        # (B, gh, p, gw, p, C) -> (B, gh*gw, p*p*C)
        x = images.to(self.dtype).reshape(b, gh, p, gw, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)
        if cfg.patch_norm:
            x = self.patch_norm_in(x)
        x = self.patch_embed(x)
        if cfg.patch_norm:
            x = self.patch_norm_out(x)
        cls = self.cls_token.to(self.dtype).expand(b, 1, cfg.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(self.dtype)
        rate = active_rate(self, cfg.emb_dropout, rng)
        x = dropout(x, rng.bits if rate > 0.0 else None, rate)
        for i in range(cfg.depth):
            x = getattr(self, f"block_{i}")(x, rng)
        if cfg.final_norm:
            x = self.final_norm(x)
        return x[:, 0]
