"""Vision Transformer encoder for UI frames and CAD images.

Port of ``videocad_tpu/models/vit.py`` (the reference's vit_pytorch
configuration: image 224, patch 32, dim 512, depth 6, 16 heads of 64, mlp
512, CLS pooling). Patches are cut by reshape in NHWC order, then
LayerNorm -> Dense -> LayerNorm (behind ``patch_norm``), a cls token and
position embedding, pre-LN blocks with exact erf GELU, a final LayerNorm
(behind ``final_norm``), and the CLS row as the embedding.

``attention_impl="fused"`` runs each block's attention core through the
hand-written ``mhsa_short`` kernels (the flagship's setting).
``attention_impl="pallas"`` runs it through the decoder's flash attention
kernels (``ops/attention.py``) without a mask, as the JAX module does.
``attention_impl="block"`` runs each block as two fused kernels
(``ops/fused_block.py``: ``attn_block`` then ``mlp_block``): LayerNorm,
projections, softmax, GELU, the four dropout sites and the residual adds of
a sub-block in one launch, whose backward recomputes everything from the
sub-block's input, so autograd keeps one (B, T, dim) tensor a sub-block: the
encoder's memory mode. ``mlp_impl="block"`` does so for the MLP sub-block
alone, beside any attention setting. The parameter names are the same under
every setting, so a checkpoint moves between them. Unlike the JAX module off
the TPU, the kernels are kept when dropout is on, on every device.

In ``train()`` mode dropout runs on the embedding, on each block's attention
output and two MLP sites, and on the attention weights (inside the fused
kernels); the ``rng`` argument of ``forward`` feeds them
(``models/layers.py``).
``forward(..., return_attention=True)`` also returns every block's
softmax weights through the plain attention core (JAX's ``sow_attention``;
``infer/interpret.py:attention_rollout`` reads them).
``dropout_impl="pallas"`` sends the elementwise sites through the
standalone dropout kernel, and ``ln_impl="pallas"`` makes every LayerNorm
of the encoder a :class:`FusedLayerNorm` on the hand-written LayerNorm
kernels, with the same parameter names either way.
``remat=True`` (the state encoder under ``remat_encoder``) recomputes the
stem and each block in the backward, one at a time, instead of keeping
their activations; the gradients are those without it, bit for bit.
``quant`` ("int8", "int8_bwd") puts the patch embedding, the attention's
projections and the MLP on the int8 product (``ops/quant.py``), as in JAX:
under ``"fused"`` only the attention core is the kernel, so the
projections around it are quantized; under ``"block"`` the fused
sub-block kernels read the raw float weights, so only the patch embedding
is quantized there (and, under ``mlp_impl="block"`` alone, the attention's
projections).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from videocad_tpu_torch.models.layers import (Dense, LayerNorm,
                                              MultiHeadAttention, active_rate,
                                              remat)
from videocad_tpu_torch.ops.dropout import DropoutRng, dropout
from videocad_tpu_torch.ops.fused_block import attn_block, mlp_block
from videocad_tpu_torch.ops.layernorm import layer_norm
from videocad_tpu_torch.ops.prng import derive_seed


class FusedLayerNorm(nn.Module):
    """:class:`LayerNorm`'s parameters and semantics on the fused kernels
    (``ops/layernorm.py``): the input cast to the compute dtype, float32
    statistics inside the kernel, output in the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.to(self.dtype), self.weight, self.bias, self.eps)


def _ln_ctor(ln_impl: str):
    return FusedLayerNorm if ln_impl == "pallas" else LayerNorm


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
    if ln_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown ln_impl {ln_impl!r}")
    if (attention_impl not in ("xla", "fused", "pallas", "block")
            or mlp_impl not in ("xla", "block")):
        raise ValueError(f"unknown ViT impls: attention {attention_impl!r}, "
                         f"mlp {mlp_impl!r}")


class ViTBlock(nn.Module):
    """One pre-LN transformer block."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype,
                 attention_impl: str = "xla", mlp_impl: str = "xla",
                 dropout_impl: str = "xla", ln_impl: str = "xla",
                 device=None, quant: str = "none"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        # Under "block" a norm module only holds the parameters that the
        # fused kernel reads.
        self.attn_norm = _ln_ctor(ln_impl)(cfg.dim, **kw)
        self.mlp_norm = _ln_ctor(ln_impl)(cfg.dim, **kw)
        self.heads = cfg.heads
        self.dropout_rate = cfg.dropout
        self.dropout_impl = dropout_impl
        self.attention_block = attention_impl == "block"
        self.mlp_block = mlp_impl == "block" or self.attention_block
        self.attn = MultiHeadAttention(cfg.dim, cfg.heads,
                                       head_dim=cfg.head_dim,
                                       dropout_rate=cfg.dropout,
                                       qkv_bias=False,
                                       attention_impl=attention_impl,
                                       dropout_impl=dropout_impl,
                                       quant=quant, **kw)
        self.mlp_in = Dense(cfg.dim, cfg.mlp_dim, quant=quant, **kw)
        self.mlp_out = Dense(cfg.mlp_dim, cfg.dim, quant=quant, **kw)

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRng] = None,
                return_attention: bool = False):
        """The block's output; with ``return_attention``, (output, the
        attention's float32 softmax weights (B, H, T, T)) from the plain
        core (dropout off there), whatever ``attention_impl`` is."""
        rate = active_rate(self, self.dropout_rate, rng)
        drop = lambda y: dropout(y, rng, rate, self.dropout_impl)  # noqa: E731
        # One seed per fused sub-block call, drawn on the host.
        seed = lambda: derive_seed(rng.seeds) if rate > 0.0 else None  # noqa: E731
        weights = None
        if return_attention:
            h = self.attn_norm(x)
            h, weights = self.attn(h, h, return_weights=True)
            x = x + drop(h)
        elif self.attention_block:
            attn = self.attn
            x = attn_block(
                x, attn.query.weight.t(), attn.key.weight.t(),
                attn.value.weight.t(), attn.out.weight.t(), attn.out.bias,
                self.attn_norm.weight, self.attn_norm.bias, seed(),
                self.heads, rate, self.attn_norm.eps)
        else:
            h = self.attn_norm(x)
            x = x + drop(self.attn(h, h, rng=rng))
        if self.mlp_block:
            x = mlp_block(
                x, self.mlp_in.weight.t(), self.mlp_in.bias,
                self.mlp_out.weight.t(), self.mlp_out.bias,
                self.mlp_norm.weight, self.mlp_norm.bias, seed(), rate,
                self.mlp_norm.eps)
        else:
            h = self.mlp_in(self.mlp_norm(x))
            # exact erf GELU (torch nn.GELU default, as the reference)
            h = self.mlp_out(drop(F.gelu(h)))
            x = x + drop(h)
        return (x, weights) if return_attention else x


class ViT(nn.Module):
    """ViT encoder: (B, H, W, C) image -> (B, dim) CLS embedding."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "xla", mlp_impl: str = "xla",
                 dropout_impl: str = "xla", ln_impl: str = "xla",
                 device=None, quant: str = "none", remat: bool = False):
        super().__init__()
        _check_impls(attention_impl, mlp_impl, ln_impl)
        self.cfg = cfg
        self.remat = remat
        self.dtype = dtype
        self.dropout_impl = dropout_impl
        ln = _ln_ctor(ln_impl)
        kw = dict(dtype=dtype, device=device)
        p = cfg.patch_size
        grid = cfg.image_size // p
        patch_dim = p * p * cfg.channels
        if cfg.patch_norm:
            self.patch_norm_in = ln(patch_dim, **kw)
        self.patch_embed = Dense(patch_dim, cfg.dim, quant=quant, **kw)
        if cfg.patch_norm:
            self.patch_norm_out = ln(cfg.dim, **kw)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.dim,
                                                  device=device))
        self.pos_embedding = nn.Parameter(
            torch.empty(1, grid * grid + 1, cfg.dim, device=device))
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", ViTBlock(
                cfg, dtype, attention_impl=attention_impl,
                mlp_impl=mlp_impl, dropout_impl=dropout_impl,
                ln_impl=ln_impl, device=device, quant=quant))
        if cfg.final_norm:
            self.final_norm = ln(cfg.dim, **kw)

    def forward(self, images: torch.Tensor,
                rng: Optional[DropoutRng] = None,
                return_attention: bool = False):
        """(B, dim) CLS embeddings; with ``return_attention``, (embeddings,
        every block's float32 attention weights (depth, B, H, N, N)), the
        counterpart of JAX's ``sow_attention``: each block's attention core
        then runs the plain score path whatever ``attention_impl`` is (the
        MLP half keeps its setting), as the JAX ViT takes its XLA path when
        it sows."""
        cfg = self.cfg
        # With remat, the stem and each block are recomputed in the
        # backward, one at a time (models/layers.py:remat).
        segment = self.remat and not return_attention
        x = (remat(self, images, rng, method=self._stem) if segment
             else self._stem(images, rng))
        weights = []
        for i in range(cfg.depth):
            block = getattr(self, f"block_{i}")
            if segment:
                x = remat(block, x, rng)
                continue
            x = block(x, rng, return_attention)
            if return_attention:
                x, w = x
                weights.append(w)
        if cfg.final_norm:
            x = self.final_norm(x)
        return (x[:, 0], torch.stack(weights)) if return_attention else x[:, 0]

    def _stem(self, images: torch.Tensor,
              rng: Optional[DropoutRng]) -> torch.Tensor:
        """Patches, their embedding, the cls token and the positions, and
        the embedding's dropout: (B, H, W, C) -> (B, N + 1, dim)."""
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
        return dropout(x, rng, rate, self.dropout_impl)
