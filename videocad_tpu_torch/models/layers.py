"""Shared layers: dense, LayerNorm, multi-head attention, decoder blocks.

Port of ``videocad_tpu/models/layers.py``. Parameters are stored in float32
under the names of the JAX parameter tree (a flax ``kernel`` (in, out)
becomes a torch ``weight`` (out, in), a LayerNorm ``scale`` becomes
``weight``), and each layer computes in the model's compute dtype with the
JAX dtype flow:

  * :class:`Dense` casts x and W to the compute dtype, multiplies, then
    adds the bias cast to the compute dtype (flax ``nn.Dense``);
  * :class:`LayerNorm` takes its statistics and affine in float32 and
    returns the compute dtype (flax ``nn.LayerNorm``), eps 1e-5;
  * :func:`xla_attention` computes and scales the scores in the compute
    dtype, runs the softmax in float32, and casts the weights back.

Decoder blocks follow torch.nn.TransformerDecoderLayer semantics (post-LN,
ReLU feed-forward, dropout on attention weights and residual branches).

Dropout is active only in ``train()`` mode and draws from the
:class:`~videocad_tpu_torch.ops.dropout.DropoutRng` handed down as the
``rng`` argument of each ``forward``: elementwise sites from its device
generator (``dropout_impl="xla"``) or through the standalone dropout kernel
with a seed derived per call from its CPU generator (``"pallas"``), the
fused attention kernel's in-kernel dropout from such a seed too. A
training-mode forward with dropout on and no ``rng`` raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from videocad_tpu_torch.ops.dropout import DropoutRng, dropout
from videocad_tpu_torch.ops.fused_attention import mhsa_short
from videocad_tpu_torch.ops.prng import derive_seed


class Dense(nn.Module):
    """flax ``nn.Dense`` in torch layout: weight (out, in), bias (out,)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics and affine, eps 1e-5, output
    in the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(torch.float32), self.weight.shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.dtype)


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """(T, T) bool, True = may attend: col <= row."""
    pos = torch.arange(seq_len, device=device)
    return pos[None, :] <= pos[:, None]


def banded_mask(q_len: int, kv_len: int, window: int,
                device=None) -> torch.Tensor:
    """(q_len, kv_len) bool banded window: row t attends cols (t-window, t]."""
    rows = torch.arange(q_len, device=device)[:, None]
    cols = torch.arange(kv_len, device=device)[None, :]
    return (cols > rows - window) & (cols <= rows)


def active_rate(module: nn.Module, rate: float,
                rng: Optional[DropoutRng]) -> float:
    """The dropout rate in force for this call: ``rate`` in ``train()``
    mode (which then needs ``rng``), 0 in ``eval()`` mode."""
    if not module.training or rate == 0.0:
        return 0.0
    if rng is None:
        raise ValueError(
            f"{type(module).__name__} in train() mode with dropout {rate} "
            "needs rng=DropoutRng(seed, device); call model.eval() for "
            "inference")
    return rate


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  dropout_rate: float = 0.0,
                  rng: Optional[DropoutRng] = None,
                  dropout_impl: str = "xla") -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + mask) v with an f32 softmax, and dropout
    on the weights when ``dropout_rate`` > 0.

    q: (B, T, H, D); k, v: (B, S, H, D); mask broadcastable to (B, H, T, S)
    bool (True = attend). Returns (B, T, H, D).
    """
    dtype = q.dtype
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    weights = torch.softmax(scores.to(torch.float32), dim=-1).to(dtype)
    weights = dropout(weights, rng, dropout_rate, dropout_impl)
    return torch.einsum("bhts,bshd->bthd", weights, v)


class MultiHeadAttention(nn.Module):
    """MHA with separate q/kv inputs and a pluggable core.

    ``attention_impl``: ``"xla"`` (plain PyTorch), or ``"fused"``, which
    routes unmasked attention through the hand-written ``mhsa_short``
    kernel exactly where the JAX module calls its Pallas kernel, with the
    attention-weight dropout inside the kernel. The flash kernel
    (``"pallas"``) is not ported yet.
    """

    def __init__(self, model_dim: int, num_heads: int,
                 head_dim: Optional[int] = None, dropout_rate: float = 0.0,
                 qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "xla", dropout_impl: str = "xla",
                 device=None):
        super().__init__()
        if attention_impl not in ("xla", "fused"):
            raise NotImplementedError(
                f"attention_impl={attention_impl!r} is not ported yet "
                "(ROADMAP kernel K3 for 'pallas', K6 for 'block')")
        self.num_heads = num_heads
        self.head_dim = head_dim or model_dim // num_heads
        self.attention_impl = attention_impl
        self.dropout_impl = dropout_impl
        self.dropout_rate = dropout_rate
        inner = num_heads * self.head_dim
        kw = dict(dtype=dtype, device=device)
        self.query = Dense(model_dim, inner, use_bias=qkv_bias, **kw)
        self.key = Dense(model_dim, inner, use_bias=qkv_bias, **kw)
        self.value = Dense(model_dim, inner, use_bias=qkv_bias, **kw)
        self.out = Dense(inner, model_dim, **kw)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, self.head_dim)

    def project_q(self, q_in: torch.Tensor) -> torch.Tensor:
        return self._split(self.query(q_in))

    def project_kv(self, kv_in: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._split(self.key(kv_in)), self._split(self.value(kv_in))

    def attend(self, q, k, v, mask=None,
               rng: Optional[DropoutRng] = None) -> torch.Tensor:
        """Core attention over projected heads; returns the merged output."""
        b, t = q.shape[:2]
        rate = active_rate(self, self.dropout_rate, rng)
        if self.attention_impl == "fused" and mask is None:
            # Unlike the JAX module off the TPU, the fused path is kept
            # when dropout is on: the kernel has its own bit function on
            # every device.
            seed = derive_seed(rng.seeds) if rate > 0.0 else None
            fused = mhsa_short(q.reshape(b, t, -1), k.reshape(b, t, -1),
                               v.reshape(b, t, -1), seed, self.num_heads,
                               rate)
            return self.out(fused)
        out = xla_attention(q, k, v, mask, rate, rng, self.dropout_impl)
        return self.out(out.reshape(b, t, self.num_heads * self.head_dim))

    def forward(self, q_in, kv_in, mask=None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        q = self.project_q(q_in)
        k, v = self.project_kv(kv_in)
        return self.attend(q, k, v, mask, rng)


class TransformerDecoderLayer(nn.Module):
    """Post-LN decoder block: self-attn -> cross-attn -> ReLU MLP."""

    def __init__(self, model_dim: int, num_heads: int, ffn_dim: int,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "xla", dropout_impl: str = "xla",
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dropout_rate = dropout_rate
        self.dropout_impl = dropout_impl
        attn_kw = dict(dropout_rate=dropout_rate,
                       attention_impl=attention_impl,
                       dropout_impl=dropout_impl, **kw)
        self.self_attn = MultiHeadAttention(model_dim, num_heads, **attn_kw)
        self.cross_attn = MultiHeadAttention(model_dim, num_heads, **attn_kw)
        self.linear1 = Dense(model_dim, ffn_dim, **kw)
        self.linear2 = Dense(ffn_dim, model_dim, **kw)
        self.norm1 = LayerNorm(model_dim, **kw)
        self.norm2 = LayerNorm(model_dim, **kw)
        self.norm3 = LayerNorm(model_dim, **kw)

    def forward(self, x, memory, tgt_mask=None, memory_mask=None,
                rng: Optional[DropoutRng] = None):
        rate = active_rate(self, self.dropout_rate, rng)
        drop = lambda y: dropout(y, rng, rate, self.dropout_impl)  # noqa: E731
        x = self.norm1(x + drop(self.self_attn(x, x, tgt_mask, rng)))
        x = self.norm2(x + drop(self.cross_attn(x, memory, memory_mask, rng)))
        ffn = self.linear2(drop(F.relu(self.linear1(x))))
        return self.norm3(x + drop(ffn))


class TransformerDecoder(nn.Module):
    """A stack of decoder layers ``layers_0 .. layers_{n-1}`` (no final
    norm, like torch's default)."""

    def __init__(self, model_dim: int, num_layers: int, num_heads: int,
                 ffn_dim: int, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "xla", dropout_impl: str = "xla",
                 device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layers_{i}", TransformerDecoderLayer(
                model_dim, num_heads, ffn_dim, dropout_rate=dropout_rate,
                dtype=dtype, attention_impl=attention_impl,
                dropout_impl=dropout_impl, device=device))

    def forward(self, x, memory, tgt_mask=None, memory_mask=None,
                rng: Optional[DropoutRng] = None):
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x, memory, tgt_mask, memory_mask,
                                             rng)
        return x
