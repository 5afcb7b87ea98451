"""Model FLOPs of VideoCADFormer, counted from the configuration's shapes.

Matrix products only, 2 m n k each (elementwise work, norms and softmax
are not counted). Attention counts the query-key pairs its mask admits:
all of them in the ViT, t + 1 for query t under the causal mask, and at
most ``window`` under the band. A training step is forward plus backward,
three times the forward (the backward's two products for each of the
forward's); no recompute is counted.
"""

from __future__ import annotations

from typing import Dict

from benchmark.reference.model import sizes

H100_BF16_FLOPS = 989e12       # dense bf16, SXM, at 700 W (data sheet)
H100_HBM_BYTES_S = 3.35e12


def vit_flops(s: Dict, image: int, channels: int) -> int:
    """One image through the ViT."""
    patches = (image // s["patch"]) ** 2
    n = patches + 1
    d, mlp = s["vit_dim"], s["vit_mlp"]
    inner = s["vit_heads"] * s["vit_head_dim"]
    total = 2 * patches * (s["patch"] ** 2 * channels) * d
    per_block = (3 * 2 * n * d * inner                          # q, k, v
                 + 2 * 2 * s["vit_heads"] * n * n * s["vit_head_dim"]
                 + 2 * n * inner * d                            # out
                 + 2 * 2 * n * d * mlp)                         # MLP
    return total + s["vit_depth"] * per_block


def attention_pairs(t: int, window: int = 0) -> int:
    """Query-key pairs of a causal (window 0) or banded mask over t."""
    if not window:
        return t * (t + 1) // 2
    return sum(min(q + 1, window) for q in range(t))


def decoder_flops(s: Dict, batch: int, t: int) -> int:
    """The embeddings, the decoder and the heads over B x T positions."""
    h, f, heads = s["hidden"], s["ffn"], s["heads"]
    rows = batch * t
    head_dim = h // heads
    embed = (2 * rows * s["vit_dim"] * h         # embed_state
             + 2 * batch * s["vit_dim"] * h      # embed_image
             + 2 * rows * 7 * h                  # embed_action
             + 2 * rows * 2 * h * h)             # image_projection
    attn = lambda pairs: 2 * 2 * batch * heads * pairs * head_dim  # noqa: E731
    per_layer = (4 * 2 * rows * h * h + attn(attention_pairs(t))
                 + 4 * 2 * rows * h * h + attn(attention_pairs(t, s["window"]))
                 + 2 * 2 * rows * h * f)
    heads_out = 2 * rows * h * (5 + 6000)
    return embed + s["layers"] * per_layer + heads_out


def forward_flops(cfg: Dict, batch: int, t: int) -> int:
    """The teacher-forced forward over (B, T) inputs."""
    s = sizes(cfg)
    cad = (vit_flops(s, 256, 3) if s["gencad"]
           else vit_flops(s, s["image"], 1))
    return (batch * t * vit_flops(s, s["image"], 1) + batch * cad
            + decoder_flops(s, batch, t))


def train_step_flops(cfg: Dict, batch: int, t: int) -> int:
    """Forward plus backward of one train step over (B, T) inputs."""
    return 3 * forward_flops(cfg, batch, t)
