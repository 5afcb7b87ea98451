"""VideoCADFormer in plain PyTorch, float32, written from the published
description: a per-frame ViT over grayscale UI frames, a CAD-image encoder
(the same ViT, or the GenCAD encoder over a 256 x 256 x 3 edge image),
embeddings of states, actions and timesteps, an 8-layer post-LN decoder
with causal self-attention and cross-attention banded to a window of
frames, and float32 heads for the command and the six parameters.

The parameters are a flat dict keyed by the program's parameter names
(``decoder.layers_3.cross_attn.key.weight``), so the mapping from the
port's names is the identity: :func:`param_spec` lists every name with its
shape, and the benchmark loads one dict into both sides.

Weights held in a :class:`LowPrecision` dict run every product in fp8
instead: the control of the checks. Departures from the port, each a
choice of form and not of result: every product runs in float32 with TF32
off (the port computes in the config's
dtype); the attention is the textbook softmax(q k^T / sqrt(d)) v over the
whole sequence with a boolean mask, never a kernel, a cache or a window
read; only the family of configurations the benchmark runs is built (ViT
encoders, past actions and states on, timestep embedding on, no multiview
images), and anything else raises.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.prng import DropoutReplay, attention_keep
from benchmark.reference.vocab import (ACT_DIM, NUM_BINS, NUM_COMMANDS,
                                       NUM_PARAMS)

_GENCAD_IMAGE = (256, 3)     # size, channels of the GenCAD edge image
_MAX_EP_LEN = 1000


def check_family(cfg: Dict) -> None:
    """Raise on a configuration outside what this reference builds."""
    wanted = {"encoder": "vit", "enable_past_actions": True,
              "enable_past_states": True, "enable_timestep_embedding": True}
    for key, value in wanted.items():
        if cfg.get(key, None) != value:
            raise ValueError(f"the reference builds {key}={value!r} only, "
                             f"got {cfg.get(key)!r}")
    if cfg.get("num_views", 0):
        raise ValueError("the reference builds no multiview images")


def sizes(cfg: Dict) -> Dict:
    """The widths, with the port's defaults for keys the JSON leaves out."""
    return {
        "hidden": cfg.get("hidden_size", 1024),
        "ffn": cfg.get("dim_feedforward", 1024),
        "heads": cfg.get("nhead", 4),
        "layers": cfg.get("num_decoder_layers", 8),
        "window": cfg.get("window_size", 1),
        "dropout": cfg.get("dropout", 0.1),
        "image": cfg.get("image_size", 224),
        "patch": cfg.get("vit_patch", 32),
        "vit_dim": cfg.get("vit_dim", 512),
        "vit_depth": cfg.get("vit_depth", 6),
        "vit_heads": cfg.get("vit_heads", 16),
        "vit_head_dim": cfg.get("vit_head_dim", 64),
        "vit_mlp": cfg.get("vit_mlp_dim", 512),
        "gencad": bool(cfg.get("use_pretrained_cad_model", False)),
    }


def _vit_spec(prefix: str, s: Dict, image: int, channels: int) -> List:
    d, inner = s["vit_dim"], s["vit_heads"] * s["vit_head_dim"]
    patch_dim = s["patch"] ** 2 * channels
    tokens = (image // s["patch"]) ** 2 + 1
    out = [(f"{prefix}.cls_token", (1, 1, d), 0.0, 0.02),
           (f"{prefix}.pos_embedding", (1, tokens, d), 0.0, 0.02)]
    out += _norm(f"{prefix}.patch_norm_in", patch_dim)
    out += _dense(f"{prefix}.patch_embed", patch_dim, d)
    out += _norm(f"{prefix}.patch_norm_out", d)
    for i in range(s["vit_depth"]):
        b = f"{prefix}.block_{i}"
        out += _norm(f"{b}.attn_norm", d) + _norm(f"{b}.mlp_norm", d)
        for name in ("query", "key", "value"):
            out += _dense(f"{b}.attn.{name}", d, inner, bias=False)
        out += _dense(f"{b}.attn.out", inner, d)
        out += _dense(f"{b}.mlp_in", d, s["vit_mlp"])
        out += _dense(f"{b}.mlp_out", s["vit_mlp"], d)
    return out + _norm(f"{prefix}.final_norm", d)


def _dense(name: str, fan_in: int, fan_out: int, bias: bool = True) -> List:
    out = [(f"{name}.weight", (fan_out, fan_in), 0.0, 1.0 / math.sqrt(fan_in))]
    return out + ([(f"{name}.bias", (fan_out,), 0.0, 0.02)] if bias else [])


def _norm(name: str, dim: int) -> List:
    return [(f"{name}.weight", (dim,), 1.0, 0.02),
            (f"{name}.bias", (dim,), 0.0, 0.02)]


def param_spec(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """Every parameter as (name, shape, mean, std) of the benchmark's
    random weights: dense weights N(0, 1 / fan_in), biases N(0, 0.02^2),
    norms N(1 or 0, 0.02^2), embeddings as their families have them."""
    check_family(cfg)
    s = sizes(cfg)
    h = s["hidden"]
    cad_image, cad_channels = (_GENCAD_IMAGE if s["gencad"]
                               else (s["image"], 1))
    out = _vit_spec("state_encoder", s, s["image"], 1)
    out += _dense("embed_state", s["vit_dim"], h)
    out += _vit_spec("cad_encoder", s, cad_image, cad_channels)
    out += _dense("embed_image", s["vit_dim"], h)
    out += _dense("embed_action", ACT_DIM, h)
    out += _dense("image_projection", 2 * h, h)
    out += [("timestep_embedding.weight", (_MAX_EP_LEN, h), 0.0,
             1.0 / math.sqrt(h))]
    for i in range(s["layers"]):
        p = f"decoder.layers_{i}"
        for attn in ("self_attn", "cross_attn"):
            for name in ("query", "key", "value", "out"):
                out += _dense(f"{p}.{attn}.{name}", h, h)
        out += _dense(f"{p}.linear1", h, s["ffn"])
        out += _dense(f"{p}.linear2", s["ffn"], h)
        for n in (1, 2, 3):
            out += _norm(f"{p}.norm{n}", h)
    out += _dense("predict_cmd", h, NUM_COMMANDS)
    out += _dense("predict_params", h, NUM_PARAMS * NUM_BINS)
    return out


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The random weights of ``seed``: one draw of N(0, 1) on ``device``
    for all of them, cut into the parameters and scaled."""
    spec = param_spec(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape, mean, std in spec:
        n = math.prod(shape)
        piece = flat[offset:offset + n].view(shape)
        out[name] = piece.mul_(std).add_(mean) if std != 1.0 or mean else piece
        offset += n
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

class LowPrecision(dict):
    """Weights whose products run in fp8: the control of the numbers that
    decide ``correct``. Every product's operands are rounded to float8
    e4m3 with a per-tensor scale (amax / 448), and in the backward the
    incoming gradient to float8 e5m2 (amax / 57344), as fp8 training
    recipes do; the rest stays float32."""


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = (_fp8(t, torch.float8_e4m3fn, 448.0) for t in (a, b))
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fp8(g, torch.float8_e5m2, 57344.0)
        grad_a = g8 @ b8.transpose(-1, -2)
        if b8.dim() == 2:      # a weight: sum over the rows of every batch
            return grad_a, (a8.reshape(-1, a8.shape[-1]).t()
                            @ g8.reshape(-1, g8.shape[-1]))
        return grad_a, a8.transpose(-1, -2) @ g8


def _mm(p: Dict, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b) if isinstance(p, LowPrecision) else a @ b


def _linear(p: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    y = _mm(p, x, p[f"{name}.weight"].t())
    bias = p.get(f"{name}.bias")
    return y + bias if bias is not None else y


def _layer_norm(p: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    w = p[f"{name}.weight"]
    return F.layer_norm(x, w.shape, w, p[f"{name}.bias"], 1e-5)


def grayscale(images: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> float32 (..., H, W, 1): ITU-R 601 luma over
    the stored channels in order, then gray / 127.5 - 1."""
    w = (0.299, 0.587, 0.114)
    gray = images[..., 0].float() * w[0]
    gray = gray + images[..., 1].float() * w[1]
    gray = gray + images[..., 2].float() * w[2]
    return (gray / 127.5 - 1.0)[..., None]


def _attention(p, q, k, v, mask, drop_probs):
    """q: (B, T, H, D), k, v: (B, S, H, D); mask (T, S) bool or None."""
    scores = _mm(p, q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(
        q.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if drop_probs is not None:
        probs = drop_probs(probs)
    return _mm(p, probs, v.transpose(1, 2)).transpose(1, 2)


def vit(p: Dict, prefix: str, s: Dict, images: torch.Tensor,
        drop: Optional[DropoutReplay] = None) -> torch.Tensor:
    """(B, H, W, C) float images -> (B, vit_dim) CLS embeddings: patches,
    LN -> dense -> LN, cls token and positions, pre-LN blocks (exact GELU),
    a final LN."""
    b, hh, ww, c = images.shape
    ps = s["patch"]
    x = images.reshape(b, hh // ps, ps, ww // ps, ps, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, (hh // ps) * (ww // ps), ps * ps * c)
    x = _layer_norm(p, f"{prefix}.patch_norm_in", x)
    x = _linear(p, f"{prefix}.patch_embed", x)
    x = _layer_norm(p, f"{prefix}.patch_norm_out", x)
    cls = p[f"{prefix}.cls_token"].expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1) + p[f"{prefix}.pos_embedding"]
    elem = drop.elementwise if drop is not None else (lambda y: y)
    x = elem(x)
    heads, hd = s["vit_heads"], s["vit_head_dim"]
    t = x.shape[1]
    for i in range(s["vit_depth"]):
        blk = f"{prefix}.block_{i}"
        h = _layer_norm(p, f"{blk}.attn_norm", x)
        q, k, v = (_linear(p, f"{blk}.attn.{n}", h).reshape(b, t, heads, hd)
                   for n in ("query", "key", "value"))
        drop_probs = None
        if drop is not None:
            seed = drop.kernel_seed()
            drop_probs = lambda w, sd=seed: _attention_dropout(  # noqa: E731
                w, sd, drop.rate)
        att = _attention(p, q, k, v, None, drop_probs).reshape(
            b, t, heads * hd)
        x = x + elem(_linear(p, f"{blk}.attn.out", att))
        h = _linear(p, f"{blk}.mlp_in", _layer_norm(p, f"{blk}.mlp_norm", x))
        h = elem(F.gelu(h))
        x = x + elem(_linear(p, f"{blk}.mlp_out", h))
    return _layer_norm(p, f"{prefix}.final_norm", x)[:, 0]


def _attention_dropout(probs: torch.Tensor, seed: int, rate: float,
                       chunk: int = 256) -> torch.Tensor:
    """The attention kernels' dropout on (B, H, T, T) weights, the mask
    drawn ``chunk`` rows at a time."""
    b, h, t, _ = probs.shape
    keep = torch.cat([attention_keep(seed, min(chunk, b - r), h, t, rate,
                                     probs.device, row_offset=r)
                      for r in range(0, b, chunk)])
    return torch.where(keep, probs * (1.0 / (1.0 - rate)), 0.0)


def decoder(p: Dict, s: Dict, x: torch.Tensor, memory: torch.Tensor,
            drop: Optional[DropoutReplay] = None) -> torch.Tensor:
    """Post-LN decoder blocks: causal self-attention, cross-attention to
    the memory within a band of ``window`` positions (t - window, t], a
    ReLU feed-forward; dropout on the attention weights and each
    residual branch."""
    t = x.shape[1]
    rows = torch.arange(t, device=x.device)[:, None]
    cols = torch.arange(t, device=x.device)[None, :]
    causal = cols <= rows
    band = (cols <= rows) & (cols > rows - s["window"])
    elem = drop.elementwise if drop is not None else (lambda y: y)
    heads = s["heads"]

    def mha(name, q_in, kv_in, mask):
        b, tq, hidden = q_in.shape
        def split(y):
            return y.reshape(b, -1, heads, hidden // heads)
        q = split(_linear(p, f"{name}.query", q_in))
        k = split(_linear(p, f"{name}.key", kv_in))
        v = split(_linear(p, f"{name}.value", kv_in))
        out = _attention(p, q, k, v, mask,
                         elem if drop is not None else None)
        return _linear(p, f"{name}.out", out.reshape(b, tq, hidden))

    for i in range(s["layers"]):
        lyr = f"decoder.layers_{i}"
        x = _layer_norm(p, f"{lyr}.norm1",
                        x + elem(mha(f"{lyr}.self_attn", x, x, causal)))
        x = _layer_norm(p, f"{lyr}.norm2", x + elem(
            mha(f"{lyr}.cross_attn", x, memory, band)))
        h = elem(F.relu(_linear(p, f"{lyr}.linear1", x)))
        x = _layer_norm(p, f"{lyr}.norm3",
                        x + elem(_linear(p, f"{lyr}.linear2", h)))
    return x


def cad_features(p: Dict, s: Dict, cad_image: torch.Tensor,
                 drop: Optional[DropoutReplay] = None) -> torch.Tensor:
    """uint8 CAD images (B, H, W, C) -> (B, hidden) CAD stream."""
    if s["gencad"]:
        images = cad_image.float() / 127.5 - 1.0
    else:
        images = grayscale(cad_image)
    return _linear(p, "embed_image", vit(p, "cad_encoder", s, images, drop))


def forward(p: Dict, cfg: Dict, frames: torch.Tensor, actions: torch.Tensor,
            cad_image: torch.Tensor,
            drop: Optional[DropoutReplay] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits: frames uint8 (B, T, H, W, 3), actions the
    normalized inputs (B, T, 7), cad_image uint8 -> ((B, T, 5),
    (B, T, 6, 1000)). ``drop`` replays the training step's dropout; None
    is inference."""
    s = sizes(cfg)
    b, t = frames.shape[:2]
    ts = p["timestep_embedding.weight"][torch.arange(t, device=frames.device)
                                        .clamp(0, _MAX_EP_LEN - 1)]
    images = grayscale(frames).reshape((b * t,) + frames.shape[2:4] + (1,))
    state = vit(p, "state_encoder", s, images, drop).reshape(b, t, -1)
    ui = torch.tanh(_linear(p, "embed_state", state) + ts[None])
    cad = cad_features(p, s, cad_image, drop)
    memory = torch.tanh(_linear(p, "image_projection", torch.cat(
        [ui, cad[:, None, :].expand(-1, t, -1)], dim=-1)))
    tgt = torch.tanh(_linear(p, "embed_action", actions) + ts[None])
    hidden = decoder(p, s, tgt, memory, drop)
    cmd = _linear(p, "predict_cmd", hidden)
    params = _linear(p, "predict_params", hidden)
    return cmd, params.reshape(b, t, NUM_PARAMS, NUM_BINS)
